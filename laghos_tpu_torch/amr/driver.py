"""AMR time loop: adaptive dt + per-step refine/derefine decisions.

The port of `laghos_tpu.amr.driver`, with the reference AMR driver's
semantics (amr/laghos.cpp:628-719):
  * refine where zone-max viscosity > ref_threshold, depth < max level,
    and the zone is still (min velocity < 1e-3) or ti < 50,
  * otherwise derefine post-shock zones by per-zone max density below
    deref_threshold * global max, protecting the blast region and zones
    not yet in motion,
  * on any change: transfer state, rebuild operators, continue.

The step lines, the trace records and the checkpoint layout are the JAX
package's, so `scripts/amr_trace_diff.py` compares the two packages'
traces and either package resumes the other's checkpoints.  The state
stays on the device; each accepted step reads the dt estimate, then the
(NE,) refinement indicators and |e| in one copy (`AMRHydro.indicators`),
besides the CG's convergence reads.

Over ranks (`parallel.sharding.shard_amr`) every rank runs this loop on
values equal on every rank (the dt minimum, the gathered indicators), so
the ranks take the same branches; they check that (t, dt, NE) agree after
each mesh change and at the end, the wall limit is decided on the largest
of the ranks' clocks, and rank 0 writes the checkpoints.
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch

from .forest import Forest
from .solver import AMRHydro


def run_amr(
    hydro: AMRHydro,
    t_final: float,
    ref_threshold: float = 2e-4,
    deref_threshold: float = 0.75,
    max_steps: int = -1,
    vis_steps: int = 5,
    verbose: bool = False,
    blast_position=(0.0, 0.0, 0.0),
    blast_amr_size: float = 1e-10,
    trace: list | None = None,
    ckpt_path: str | None = None,
    ckpt_every: int = 100,
    resume: dict | None = None,
    wall_limit: float | None = None,
):
    """Returns the run summary; with `trace` a list, appends one record
    per step ({ti, t, dt, NE, e_norm, n_ref, n_deref, changed} for an
    accepted step, {ti, event: "reject", dt, NE} for a rejected one) —
    the step-indexed trajectory used to localize divergence against
    reference runs (amr/README.md validation).

    With `ckpt_path`, a resumable checkpoint (forest leaves + x0_T +
    state + loop counters) is written atomically every `ckpt_every`
    accepted steps; pass a loaded checkpoint as `resume` (with a hydro
    built via `resume_amr_hydro`) to continue a run bit-identically.
    With `wall_limit` (seconds) the run also ends with the first attempt
    that starts after that much wall time, as if max_steps were reached.

    Besides the JAX package's keys (steps, t, dt, e_norm, norms, NE) the
    summary holds "mesh_changes" and "seconds": {"rebuild": host seconds
    in the refine/derefine transfers and rebuilds, "stepping": the rest of
    the loop}."""
    comm = hydro.comm
    if resume is not None:
        t = float(resume["t"])
        dt = float(resume["dt"])
        steps = int(resume["steps"])
        ti = int(resume["ti"])
        count_stage1 = bool(resume["count_stage1"])
        norms = {int(k): float(v) for k, v in resume["norms"].items()}
        S = hydro.state
    else:
        t = 0.0
        S = hydro.state
        dt = float(hydro.qupdate(S)[1])
        steps = 0
        count_stage1 = False
        ti = 1
        norms = {}
    last_step = False
    n_changes = 0
    t_rebuild = 0.0
    t_loop = time.perf_counter()
    while not last_step:
        if t + dt >= t_final:
            dt = t_final - t
            last_step = True
        if steps == max_steps or (
                wall_limit is not None
                and _elapsed(comm, t_loop) > wall_limit):
            last_step = True
        S_old, t_old = S, t
        S_new, dt_est, visc_max, _ = hydro.advance(S, dt, count_stage1)
        count_stage1 = False
        steps += 1
        dt_est = float(dt_est)
        if dt_est < dt:
            dt *= 0.85
            if dt < np.finfo(np.float64).eps:
                raise RuntimeError("The time step crashed!")
            S, t = S_old, t_old
            count_stage1 = True     # ResetQuadratureData: stage 1 will
            if steps < max_steps:   # recompute and count in dt_est
                last_step = False
            if trace is not None:
                trace.append({"ti": ti, "event": "reject", "dt": dt,
                              "NE": hydro.NE})
            continue
        S = S_new
        t += dt
        if dt_est > 1.25 * dt:
            dt *= 1.02

        hydro.state = S
        ind = hydro.indicators(S, visc_max, blast_position, blast_amr_size)
        if last_step or ti % vis_steps == 0:
            en = ind["e_norm"]
            norms[ti] = en
            if verbose:
                print(f"step {ti:5d},\tt = {t:.4f},\tdt = {dt:.6f},"
                      f"\t|e| = {en:.10e}  NE={hydro.NE}")

        # ---- AMR block (amr/laghos.cpp:628-719) -------------------------
        est = ind["est"]
        # GetPerElementMinMax(v_gf): min/max of |v| at Gauss points of
        # order order_v + 1 (amr/laghos.cpp:631-633, 846-857)
        v_min = ind["v_min"]
        order = hydro.forest.leaf_list()
        depths = hydro.forest.depths()
        refs = [order[i] for i in range(hydro.NE)
                if est[i] > ref_threshold
                and depths[i] < hydro.forest.max_depth
                and (v_min[i] < 1e-3 or ti < 50)]
        changed = False
        derefs = []
        t0 = time.perf_counter()
        if refs:
            changed = hydro.apply_amr(refine_keys=refs)
            # nc_limit=1 is enforced globally on every refinement call
            # (MFEM LimitNCLevel); one level per pass, transfers chained
            while changed:
                viol = hydro.forest.balance_violations(1)
                if not viol:
                    break
                hydro.apply_amr(refine_keys=viol)
            if changed and verbose:
                print(f"Refined {len(refs)} -> {hydro.NE} elements.")
        elif deref_threshold:
            # DerefineByError(rho_max, threshold, nc_limit, op=max) with
            # rho_max = per-zone max of the projected density at Gauss
            # points (amr/laghos.cpp:663-698)
            rho_max = ind["rho_max"]
            threshold = deref_threshold * rho_max.max()
            protect = rho_max.copy()
            # blast protection: elements with a (deformed) corner vertex
            # within blast_amr_size of the blast position
            # (FindElementsWithVertex, amr/laghos.cpp:674-683)
            protect[ind["near_blast"]] = 1e10
            # only derefine where the mesh is in motion (post-shock)
            protect[v_min < 0.1] = 1e10
            derefs = [order[i] for i in range(hydro.NE)
                      if protect[i] < threshold]
            if derefs:
                changed = hydro.apply_amr(deref_keys=derefs)
                if changed and verbose:
                    print(f"Derefined -> {hydro.NE} elements.")
        if changed:
            S = hydro.state
            count_stage1 = True     # AMRUpdate invalidates quad data
            n_changes += 1
            t_rebuild += time.perf_counter() - t0
            _check_lockstep(comm, t, dt, hydro.NE, "mesh change")
        if trace is not None:
            trace.append({
                "ti": ti, "t": t, "dt": dt, "NE": hydro.NE,
                "e_norm": hydro.e_norm() if changed else ind["e_norm"],
                "n_ref": len(refs), "n_deref": len(derefs),
                "changed": bool(changed)})
        ti += 1
        if (ckpt_path is not None and not last_step
                and (ti - 1) % ckpt_every == 0):
            save_checkpoint(ckpt_path, hydro, t, dt, steps, ti,
                            count_stage1, norms, trace)

    if ckpt_path is not None and t < t_final - 1e-14:
        # run ended by max_steps, not t_final: leave a resume point
        save_checkpoint(ckpt_path, hydro, t, dt, steps, ti,
                        count_stage1, norms, trace)
    e_final = hydro.e_norm()
    _check_lockstep(comm, t, dt, hydro.NE, "run")
    loop = time.perf_counter() - t_loop
    return {"steps": ti - 1, "t": t, "dt": dt, "e_norm": e_final,
            "norms": norms, "NE": hydro.NE, "mesh_changes": n_changes,
            "seconds": {"rebuild": t_rebuild,
                        "stepping": loop - t_rebuild}}


def _elapsed(comm, t0):
    """Seconds since `t0`; over ranks the largest rank's, the same on every
    rank, so that the wall limit ends every rank at one attempt."""
    s = time.perf_counter() - t0
    if comm is None:
        return s
    return float(comm.allreduce_max(torch.tensor(s, dtype=torch.float64)))


def _check_lockstep(comm, t, dt, NE, what):
    if comm is not None:
        from ..parallel.segment import check_lockstep

        check_lockstep(comm, (t, dt, NE), what)


def save_checkpoint(path, hydro, t, dt, steps, ti, count_stage1, norms,
                    trace=None):
    """Atomically write a resumable AMR run checkpoint: a pickle of NumPy
    arrays and Python scalars, the JAX package's layout.  Over ranks a
    collective: the global state is gathered and rank 0 writes it."""
    f = hydro.forest
    xT, vT, e = hydro.global_state()
    if hydro.comm is not None and hydro.comm.rank != 0:
        return
    ck = {
        "forest": {"dim": f.dim, "base_n": f.base_n, "sizes": f.sizes,
                   "max_depth": f.max_depth, "leaves": list(f.leaf_list())},
        "x0_T": np.asarray(hydro.x0_T, np.float64),
        "h0": float(hydro._h0),
        "xT": xT, "vT": vT, "e": e,
        "t": float(t), "dt": float(dt), "steps": int(steps), "ti": int(ti),
        "count_stage1": bool(count_stage1),
        "norms": {int(k): float(v) for k, v in norms.items()},
    }
    if trace is not None:
        ck["trace"] = list(trace)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fp:
        pickle.dump(ck, fp)
    os.replace(tmp, path)


def load_checkpoint(path):
    with open(path, "rb") as fp:
        return pickle.load(fp)


def resume_amr_hydro(ck, opt, dtype=None, device="cuda"):
    """Rebuild the AMRHydro a checkpoint was taken from, on `device`."""
    f = Forest.from_leaves(**ck["forest"])
    return AMRHydro(f, opt, dtype=dtype or torch.float64, ckpt=ck,
                    device=device)
