"""Profile steady-state steps of the port's operator paths on one card.

    python -m laghos_tpu_torch.profile_steps [--cases NAME ...] \
        [--repeats 2] [--out FILE]

For each case (3D Sedov, RK2Avg, f64, `-cgt 1e-11`, at the flagship sizes
of `chip_smoke.py`, and Q8-Q7 at phase 18's), builds the `Hydro`, takes 2
warm-up steps, times 5 steps (`step_ms`, host wall time ending in a device
sync), then runs `--repeats` windows of 2 steps under `torch.profiler`.
Each window gives one JSON line: the device's busy time per step (the union of the traced
device intervals), busy share of the window's wall time, device events
per step, the ops and kernels with the most device time, and the device
time and launches per step of each hand-written kernel (`csrc/*.cu`,
found by its device-side name: the ctypes launches are no torch ops, so
`key_averages()` does not list them).  The lines go to stdout and, with
`--out`, to FILE.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

# name -> (rs, order_v, order_e, Options overrides)
CASES = {
    "ns2_lattice_jacobi": (4, 2, 1, dict(precond="jacobi")),
    "ns2_lattice_kron": (4, 2, 1, dict(precond="kron")),
    "ns2_gather": (4, 2, 1, dict(structured_el=False, lattice_ops=False,
                                 precond="jacobi")),
    "ns4_lattice_jacobi": (3, 4, 3, dict(precond="jacobi")),
    "ns4_lattice_kron": (3, 4, 3, dict(precond="kron")),
    "ns2_lattice_ozaki": (4, 2, 1, dict(precond="jacobi", ozaki=True)),
    # Q8-Q7 at rs3 (the JAX package's q8 row in f64): NE 4,096, 16.8M
    # q-points, 6.44M H1 dofs; `--cases q8_lattice_jacobi` alone
    "q8_lattice_jacobi": (3, 8, 7, dict(precond="jacobi")),
}


# device-side names of the hand-written kernels (csrc/split.cu, csrc/qphys.cu,
# csrc/mass.cu: mass_kernel and mass_kernel_rt; csrc/lattice_mass.cu: its
# element stages, lattice_mass_stages and lattice_mass_stages_rt, and its
# assembly, two launches an apply; csrc/cg.cu: the CG chain's five kernels,
# one launch each an iteration); no name is a part of another
HAND_KERNELS = ("split_kernel", "qphys_kernel", "mass_kernel",
                "lattice_mass_stages", "lattice_mass_assemble",
                "cg_update_kernel", "cg_finish_kernel", "cg_direction_kernel",
                "cg_ess_dot_kernel", "cg_den_kernel")


def hand_kernel_times(events, steps):
    """{kernel: {ms_per_step, launches_per_step}} of each of HAND_KERNELS
    over the profiler's device events of `steps` steps."""
    acc = {k: [0.0, 0] for k in HAND_KERNELS}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for k in HAND_KERNELS:
            if k in e.name:
                acc[k][0] += e.time_range.end - e.time_range.start
                acc[k][1] += 1
    return {k: dict(ms_per_step=us / steps / 1e3, launches_per_step=n / steps)
            for k, (us, n) in acc.items()}


def _busy(prof):
    """(union of the device intervals in us, number of device events)."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    total, cur = 0, None
    for s, t in iv:
        if cur is None or s > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [s, t]
        else:
            cur[1] = max(cur[1], t)
    if cur is not None:
        total += cur[1] - cur[0]
    return total, len(iv)


def profile_case(dev, rs, order_v, order_e, opt, *, warm=2, timed=5,
                 window=2, repeats=2):
    """Records of one case: the timed steps, then one per profiled
    window."""
    from .fem import mesh as fmesh
    from .hydro import Hydro, Options

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    m = fmesh.cartesian(3, (2, 2, 2), (1.0, 1.0, 1.0))
    for _ in range(rs):
        m = fmesh.uniform_refine(m)
    t0 = time.perf_counter()
    h = Hydro(m, Options(problem=1, ode_solver=7, cg_tol=1e-11,
                         order_v=order_v, order_e=order_e, **opt),
              device=dev)
    setup_s = time.perf_counter() - t0
    dt, sj = h.dt_estimate_full(h.S0)
    dt = 0.5 * float(dt)
    S = h.S0
    for _ in range(warm):
        S, _, _, sj = h.advance(S, dt, sJit1=sj)
    sync()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    iters = []
    t0 = time.perf_counter()
    for _ in range(timed):
        S, _, st, sj = h.advance(S, dt, sJit1=sj)
        iters.append([int(st[0]), int(st[1])])
    sync()
    step_ms = (time.perf_counter() - t0) / timed * 1e3
    rec = dict(NE=h.NE, NQ=h.NQ, lattice=h._lat_dims, setup_s=setup_s,
               step_ms=step_ms, cg_iters_h1_l2=iters)
    if h.oz is not None:
        rec["ir_stats"] = h.ir_stats()
    if dev.type == "cuda":
        rec["peak_GiB"] = torch.cuda.max_memory_allocated() / 2**30
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    out = [rec]
    for r in range(repeats):
        with profile(activities=acts) as prof:
            t1 = time.perf_counter()
            for _ in range(window):
                S, _, _, sj = h.advance(S, dt, sJit1=sj)
            sync()
            wall = time.perf_counter() - t1
        busy_us, n = _busy(prof)
        top = sorted(((k.key, k.device_time_total, k.count)
                      for k in prof.key_averages()
                      if k.device_time_total > 0), key=lambda r: -r[1])[:12]
        out.append(dict(
            repeat=r, wall_ms_per_step=wall / window * 1e3,
            busy_ms_per_step=busy_us / window / 1e3,
            busy_share=busy_us / 1e6 / wall,
            device_events_per_step=n / window,
            hand_kernels=hand_kernel_times(prof.events(), window),
            top=[(k[:90], t / window / 1e3, c // window)
                 for k, t, c in top]))
    return out


def main(argv=None):
    from .device import setup

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", nargs="+", choices=sorted(CASES),
                    default=list(CASES))
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    dev = setup(a.device)
    sink = open(a.out, "a") if a.out else None
    try:
        for name in a.cases:
            rs, ov, oe, opt = CASES[name]
            for rec in profile_case(dev, rs, ov, oe, opt,
                                    repeats=a.repeats):
                line = json.dumps({"case": name, **rec})
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        if sink:
            sink.close()
    if dev.type == "cuda":
        print(torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main()
