"""Time-integration driver: adaptive dt with step repetition.

Host-side control loop mirroring the reference's main loop
(laghos.cpp:741-920): `Hydro.advance` does the device work; the scalar dt
control decisions (one read of dt_est per step) live in Python, as the
reference keeps them outside its device kernels.  With `device_loop` the
control scalars stay on the device instead (`Hydro.run_segment`): the same
trajectory, bit for bit, with fewer host syncs.

Under `timing.trace` each attempt runs in a "laghos.step" range, the dt
read and its decision in "laghos.dt_read", and the vis-step work (|e|,
`on_vis`, the checkpoint) in "laghos.vis"; every read of a device value
goes through `timing.host_read`, so the tracer counts it.  With `timing`
the run is traced too, and each phase of `Hydro.advance` is fenced and
timed into a TimingData (`hydro._phase`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from .hydro import Hydro
from .timing import (TimingData, attempt, block, charge, host_read, span,
                     trace)


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
    device_loop: bool = False,
) -> RunResult:
    """Run from S_init (default hydro.S0) at t_init to t_final.

    With dt_init (a resumed run: t_init, dt_init and step_init = the saved
    step + 1 from a checkpoint), the first step recomputes its stage-1
    q-data instead of reusing the memoized one, as the JAX package's host
    loop does; the trajectory is the uninterrupted run's bit for bit.  At
    every vis step (and the last) `on_vis(step, t, S)` is called and, with
    checkpoint_path, a snapshot (S, t, dt, step) is written there.

    `device_loop` runs the control flow on the device (`_run_device_loop`;
    not with `timing`).  `timing` fences and times the phases of every
    step's `Hydro.advance` into `RunResult.timing_data`; the steps are the
    untimed run's, bit for bit."""
    S = hydro.S0 if S_init is None else S_init
    energy_init = _energy(hydro, S)
    if device_loop:
        if timing:
            raise ValueError("the device loop takes no phase timing")
        return _run_device_loop(
            hydro, S, energy_init, t_final, max_steps=max_steps,
            vis_steps=vis_steps, on_vis=on_vis, check_steps=check_steps,
            verbose=verbose, t_init=t_init, dt_init=dt_init,
            step_init=step_init, checkpoint_path=checkpoint_path)
    with trace() if timing else contextlib.nullcontext():
        return _run_host_loop(
            hydro, S, energy_init, t_final,
            TimingData() if timing else None, max_steps=max_steps,
            vis_steps=vis_steps, on_vis=on_vis, check_steps=check_steps,
            verbose=verbose, t_init=t_init, dt_init=dt_init,
            step_init=step_init, checkpoint_path=checkpoint_path)


def _energy(hydro, S):
    ie, ke = hydro.energies(S)
    return host_read(ie) + host_read(ke)


def _run_host_loop(
    hydro, S, energy_init, t_final, tim, *, max_steps, vis_steps, on_vis,
    check_steps, verbose, t_init, dt_init, step_init, checkpoint_path,
) -> RunResult:
    """The adaptive-dt loop on the host (laghos.cpp:741-920); with the
    TimingData `tim`, the phases of each `advance` charge it."""
    t = t_init
    if dt_init is not None:
        dt = dt_init
        sJit_prev = None
    else:
        hydro.current_step = step_init
        dt0, sJit_prev = hydro.dt_estimate_full(S)
        dt = host_read(dt0)
    last_step = False
    steps = 0
    ti = step_init
    h1_iters = 0
    l2_iters = 0
    quad_steps = 0
    norms = {}
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
        with span("laghos.step"):
            with charge(tim):
                S_new, dt_est, (h1it, l2it), sJit_new = hydro.advance(
                    S, dt, count_stage1, sJit1=sJit_prev)
            count_stage1 = False
            steps += 1
            with span("laghos.dt_read"):
                dt_est = host_read(dt_est)
                rejected = dt_est < dt
                if rejected:
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
            attempt(ti, not rejected)
            if rejected:
                continue
            S = S_new
            t += dt
            sJit_prev = sJit_new
            h1_iters += host_read(h1it)
            l2_iters += host_read(l2it)
            quad_steps += hydro.NE
            if dt_est > 1.25 * dt:
                dt *= 1.02

            if last_step or (ti % vis_steps) == 0 or ti in check_steps:
                with span("laghos.vis"):
                    en = hydro.e_norm(S)
                    norms[ti] = en
                    if verbose:
                        print(f"step {ti:5d},\tt = {t:.4f},\tdt = {dt:.6f},"
                              f"\t|e| = {en:.10e}")
                    if on_vis is not None:
                        on_vis(ti, t, S)
                    if checkpoint_path is not None:
                        hydro.save_checkpoint(checkpoint_path, S, t, dt, ti)
        ti += 1

    block(S)
    wall = time.perf_counter() - t0
    if tim is not None:
        tim.settle()
    return RunResult(
        steps=ti - 1,
        t=t,
        dt=dt,
        e_norm=hydro.e_norm(S),
        energy_init=energy_init,
        energy_final=_energy(hydro, S),
        h1_iters=h1_iters,
        l2_iters=l2_iters,
        quad_steps=quad_steps,
        norms=norms,
        timings={"total": wall},
        timing_data=tim,
        S=S,
    )


def _run_device_loop(
    hydro, S, energy_init, t_final, *, max_steps, vis_steps, on_vis,
    check_steps, verbose, t_init, dt_init, step_init, checkpoint_path,
) -> RunResult:
    """The adaptive-dt loop with its control scalars on the device
    (`Hydro.run_segment`), paused at every vis step, check step and the
    end of the run, where |e| is read, the step line printed, `on_vis`
    called and the checkpoint written.  The same trajectory, step numbers,
    printed lines ("Repeating step" included), `norms` and CG totals as
    the host loop, bit for bit.  A resumed run (dt_init) rebuilds the
    memoized stage-1 q-data from S and, as the host loop does, does not
    count its dt in the first step's estimate."""
    hydro.current_step = step_init
    dt0, sJit = hydro.dt_estimate_full(S)
    dt = dt0 if dt_init is None else float(dt_init)
    t, ti, steps, count_stage1 = t_init, step_init, 0, False
    h1_iters = l2_iters = 0
    norms = {}
    chk = sorted(check_steps) or [-1]
    on_reject = (lambda i: print(f"Repeating step {i}")) if verbose else None
    t0 = time.perf_counter()
    while True:
        (S, t, dt, ti_t, steps_t, sJit, cs1, done, crashed, h1a, l2a,
         pause) = hydro.run_segment(S, t, dt, ti, steps, sJit, count_stage1,
                                    t_final, max_steps, vis_steps, chk,
                                    on_reject=on_reject)
        ti, steps, h1, l2, count_stage1, done, crashed = host_read(
            torch.stack([ti_t, steps_t, h1a, l2a, cs1.long(), done.long(),
                         crashed.long()]))
        h1_iters += h1
        l2_iters += l2
        if crashed:
            raise RuntimeError("The time step crashed!")
        if not count_stage1:
            # the segment ended on an accepted step: a pause or the end
            with span("laghos.vis"):
                t_h, dt_h = host_read(torch.stack([t, dt]))
                en = hydro.e_norm(S)
                norms[ti - 1] = en
                if verbose:
                    print(f"step {ti - 1:5d},\tt = {t_h:.4f},"
                          f"\tdt = {dt_h:.6f},\t|e| = {en:.10e}")
                if on_vis is not None:
                    on_vis(ti - 1, t_h, S)
                if checkpoint_path is not None:
                    hydro.save_checkpoint(checkpoint_path, S, t_h, dt_h,
                                          ti - 1)
        if done:
            break

    block(S)
    wall = time.perf_counter() - t0
    t, dt = host_read(torch.stack([t, dt]))
    return RunResult(
        steps=ti - 1,
        t=t,
        dt=dt,
        e_norm=hydro.e_norm(S),
        energy_init=energy_init,
        energy_final=_energy(hydro, S),
        h1_iters=h1_iters,
        l2_iters=l2_iters,
        quad_steps=(ti - step_init) * hydro.NE,
        norms=norms,
        timings={"total": wall},
        timing_data=None,
        S=S,
    )
