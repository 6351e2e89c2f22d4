"""Time-integration driver: adaptive dt with step repetition.

Host-side control loop mirroring the reference's main loop
(laghos.cpp:741-920): `Hydro.advance` does the device work; the scalar dt
control decisions (one read of dt_est per step) live in Python, as the
reference keeps them outside its device kernels.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from . import checkpoint
from .hydro import Hydro
from .timing import TimingData, block


@dataclasses.dataclass
class RunResult:
    steps: int
    t: float
    dt: float
    e_norm: float
    energy_init: float
    energy_final: float
    h1_iters: int
    l2_iters: int
    quad_steps: int
    norms: dict          # step -> |e| at the steps where it was sampled
    timings: dict
    timing_data: Optional[TimingData] = None
    S: Optional[dict] = None  # final state


def run(
    hydro: Hydro,
    t_final: float,
    max_steps: int = -1,
    vis_steps: int = 5,
    on_vis: Optional[Callable] = None,
    check_steps: tuple = (),
    verbose: bool = False,
    timing: bool = False,
    S_init=None,
    t_init: float = 0.0,
    dt_init: Optional[float] = None,
    step_init: int = 1,
    checkpoint_path: Optional[str] = None,
) -> RunResult:
    """Run from S_init (default hydro.S0) at t_init to t_final.

    With dt_init (a resumed run: t_init, dt_init and step_init = the saved
    step + 1 from a checkpoint), the first step recomputes its stage-1
    q-data instead of reusing the memoized one, as the JAX package's host
    loop does; the trajectory is the uninterrupted run's bit for bit.  At
    every vis step (and the last) `on_vis(step, t, S)` is called and, with
    checkpoint_path, a snapshot (S, t, dt, step) is written there."""
    S = hydro.S0 if S_init is None else S_init
    ie, ke = hydro.energies(S)
    energy_init = float(ie) + float(ke)

    t = t_init
    if dt_init is not None:
        dt = dt_init
        sJit_prev = None
    else:
        hydro.current_step = step_init
        dt0, sJit_prev = hydro.dt_estimate_full(S)
        dt = float(dt0)
    last_step = False
    steps = 0
    ti = step_init
    h1_iters = 0
    l2_iters = 0
    quad_steps = 0
    norms = {}
    tim = TimingData() if timing else None
    t0 = time.perf_counter()
    count_stage1 = False  # stage-1 qdata is memoized except after rollback

    while not last_step:
        if t + dt >= t_final:
            dt = t_final - t
            last_step = True
        if steps == max_steps:
            last_step = True
        S_old, t_old = S, t
        hydro.current_step = ti

        if timing:
            S_new, dt_est, (h1it, l2it), sJit_new = hydro.advance_timed(
                S, dt, tim, count_stage1, sJit1=sJit_prev)
        else:
            S_new, dt_est, (h1it, l2it), sJit_new = hydro.advance(
                S, dt, count_stage1, sJit1=sJit_prev)
        count_stage1 = False
        steps += 1
        dt_est = float(dt_est)

        if dt_est < dt:
            # Repeat with decreased dt (laghos.cpp:764-777)
            dt *= 0.85
            if dt < np.finfo(np.float64).eps:
                raise RuntimeError("The time step crashed!")
            t = t_old
            S = S_old
            count_stage1 = True
            sJit_prev = None  # qdata reset (laghos.cpp:773)
            if verbose:
                print(f"Repeating step {ti}")
            # faithful to laghos.cpp:775 (including max_tsteps = -1)
            if steps < max_steps:
                last_step = False
            continue
        S = S_new
        t += dt
        sJit_prev = sJit_new
        h1_iters += int(h1it)
        l2_iters += int(l2it)
        quad_steps += hydro.NE
        if dt_est > 1.25 * dt:
            dt *= 1.02

        if last_step or (ti % vis_steps) == 0 or ti in check_steps:
            en = hydro.e_norm(S)
            norms[ti] = en
            if verbose:
                print(f"step {ti:5d},\tt = {t:.4f},\tdt = {dt:.6f},"
                      f"\t|e| = {en:.10e}")
            if on_vis is not None:
                on_vis(ti, t, S)
            if checkpoint_path is not None:
                checkpoint.save(checkpoint_path, S, t, dt, ti)
        ti += 1

    block(S)
    wall = time.perf_counter() - t0
    ie, ke = hydro.energies(S)
    return RunResult(
        steps=ti - 1,
        t=t,
        dt=dt,
        e_norm=hydro.e_norm(S),
        energy_init=energy_init,
        energy_final=float(ie) + float(ke),
        h1_iters=h1_iters,
        l2_iters=l2_iters,
        quad_steps=quad_steps,
        norms=norms,
        timings={"total": wall},
        timing_data=tim,
        S=S,
    )
