"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path (`laghos_tpu_torch`) through the entry points a
user calls, at the reference's 3D Sedov benchmark size, and checks it:

1. device: the card, its power limit, and the torch/CUDA/nvcc versions;
2. build of the hand-written CUDA kernel (csrc/qphys.cu) from this checkout;
3. the kernel against its plain PyTorch version on the card, f64 and f32,
   on the q-data of the flagship mesh (2,097,152 points) with inverted and
   NaN points mixed in, with launch times;
4. the reference's --checks goldens (3D and 2D Sedov) through the port's
   driver on the card;
5. the flagship run through the CLI: 3D Sedov, rs4, Q2-Q1, RK2Avg, f64
   (and a short f32 run for the f32 kernel instance), with FOM, CG
   iterations, energy drift and peak memory;
6. bitwise repeatability of two runs.

Every phase raises on failure.  The last two lines are a JSON record of the
kernels and the JSON status line; neither is printed unless every phase
passed.  Exits non-zero without CUDA.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

FLAGSHIP = ["-p", "1", "-dim", "3", "-rs", "4", "-ok", "2", "-ot", "1",
            "-s", "7", "-cgt", "1e-11", "-ms", "20", "-f", "-vs", "5",
            "-d", "cuda"]
FLAGSHIP_F32 = ["-p", "1", "-dim", "3", "-rs", "4", "-ok", "2", "-ot", "1",
                "-s", "7", "-cgt", "2e-7", "-ms", "3", "--dtype", "f32",
                "-vs", "5", "-d", "cuda"]
SOURCE = "laghos_tpu_torch/csrc/qphys.cu"
REPLACES = {torch.float64: "laghos_tpu/ops/pallas_df64.py:132",
            torch.float32: "laghos_tpu/ops/pallas_qphys.py:211"}
# kernel vs plain version on the card, relative to max|sJit|.  Both run
# the same operations; they differ only where nvcc contracts a*b+c into FMA
# and the plain version rounds twice.  f64: ~1e-16 observed, 1e-12 asked.
# f32: ~1e-9 observed on an H100 (the f32 eigen-solve of the strain rate
# can amplify an ulp of difference); 1e-5 is about 80 f32 ulps of max|sJit|.
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_device():
    from laghos_tpu_torch.device import setup

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False")
    dev = setup("cuda")
    from laghos_tpu_torch.ops import kernels

    nvcc = subprocess.run([kernels._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60)
    log(f"[1 device] nvidia-smi: {card_line()}")
    log(f"[1 device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    log(f"[1 device] {torch.cuda.get_device_name(dev)} "
        f"(count {torch.cuda.device_count()})")
    return dev


def phase_build():
    from laghos_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    lib, b = kernels.library()
    log(f"[2 build] {b.path.name} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {b.seconds:.2f} s)")
    for line in b.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[2 build] ptxas: {line.strip()}")


def flagship_hydro(device, dtype=torch.float64):
    from laghos_tpu_torch.fem import mesh as fmesh
    from laghos_tpu_torch.hydro import Hydro, Options

    m = fmesh.cartesian(3, (2, 2, 2), (1.0, 1.0, 1.0))
    for _ in range(4):
        m = fmesh.uniform_refine(m)
    return Hydro(m, Options(problem=1, ode_solver=7, cg_tol=1e-11),
                 dtype=dtype, device=device)


def qdata_inputs(h, seed=0):
    """q-data of `h` at t=0 with the velocity perturbed by a seeded field
    (so the viscous branch is active), and a few inverted and NaN points."""
    from laghos_tpu_torch.ops import qupdate as qop
    from laghos_tpu_torch.ops import tensor as top

    rng = np.random.default_rng(seed)
    S = h.S0
    dv = torch.tensor(rng.normal(size=tuple(S["v"].shape)) * 0.1,
                      dtype=h.dtype, device=h.device)
    v = S["v"] + dv
    x_e, v_e = h._gather_e(S["x"]), h._gather_e(v)
    J9 = qop._grad9(x_e, h.tables["H1B"], h.tables["H1G"], h.nd1, h.NQ)
    dV9 = qop._grad9(v_e, h.tables["H1B"], h.tables["H1G"], h.nd1, h.NQ)
    et = S["e"].reshape((h.NE,) + (h.l1d,) * 3)
    e_q = top.eval_values(et, h.tables["L2B"], 3).reshape(h.NE, h.NQ)
    e_q = e_q + 0.5             # nonzero pressure everywhere
    pts = rng.choice(h.NE * h.NQ, size=8, replace=False)
    el, q = pts // h.NQ, pts % h.NQ
    J9[:, el[:4], q[:4]] *= -1.0                  # detJ < 0
    J9[4, el[4:6], q[4:6]] = float("nan")         # NaN geometry
    e_q[el[6:], q[6:]] = float("nan")             # NaN energy
    return dict(J9=J9.contiguous(), dV9=dV9.contiguous(),
                J0i9=h.Jac0inv_t, e_q=e_q.contiguous(), rw=h.rho0DetJ0w_t,
                gamma=h.gamma_t, winv=h.tables["Winv"]), h


def time_ms(fn, n=20):
    """Median over n calls of fn's device time, CUDA events per call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def compare(inp, h, dtype):
    from laghos_tpu_torch.ops import qphys

    args = [inp[k].to(dtype) for k in ("J9", "dV9", "J0i9", "e_q", "rw",
                                       "gamma", "winv")]
    kw = dict(h0_e=h.h0, h1order=float(h.opt.order_v), cfl=h.opt.cfl,
              use_viscosity=True, use_vorticity=False)
    sk, dk = qphys.physics_3d(*args, **kw)
    sp, dp = qphys.physics_3d_plain(*args, **kw)
    torch.cuda.synchronize()
    nan_k, nan_p = torch.isnan(sk), torch.isnan(sp)
    if not torch.equal(nan_k, nan_p):
        raise AssertionError(f"{dtype}: NaN patterns of sJit differ")
    zk, zp = dk == 0, dp == 0
    if not torch.equal(zk, zp):
        raise AssertionError(f"{dtype}: dtq == 0 masks differ "
                             f"({int(zk.sum())} vs {int(zp.sum())})")
    fin = ~nan_p
    scale = float(sp[fin].abs().max())
    err = float((sk[fin] - sp[fin]).abs().max())
    good = dp > 0
    dmin_k, dmin_p = float(dk[good].min()), float(dp[good].min())
    drel = abs(dmin_k - dmin_p) / dmin_p
    tol = TOL[dtype]
    log(f"[3 kernel] {str(dtype)[6:]}: max|dsJit| {err:.3e} = "
        f"{err / scale:.3e} x max|sJit| (tol {tol:g}); dtq.min rel diff "
        f"{drel:.3e}; zero-dt points {int(zp.sum())}, NaN sJit points "
        f"{int(nan_p[0].sum())}")
    if not err <= tol * scale or not drel <= tol:
        raise AssertionError(f"{dtype}: kernel disagrees with the plain "
                             "version")
    if int(zp.sum()) < 8:
        raise AssertionError("injected inverted/NaN points did not reach "
                             "dt = 0")
    ms = time_ms(lambda: qphys.physics_3d(*args, **kw))
    plain_ms = time_ms(lambda: qphys.physics_3d_plain(*args, **kw))
    log(f"[3 kernel] {str(dtype)[6:]}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms (median of 20, N = {args[3].numel()})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def phase_kernel(dev):
    inp, h = qdata_inputs(flagship_hydro(dev))
    out = {dt: compare(inp, h, dt) for dt in (torch.float64, torch.float32)}
    del inp, h
    torch.cuda.empty_cache()
    return out


def phase_goldens(dev):
    from laghos_tpu_torch import driver
    from laghos_tpu_torch.fem import mesh as fmesh
    from laghos_tpu_torch.hydro import Hydro, Options
    from laghos_tpu_torch.ops.qphys import physics_3d
    from laghos_tpu_torch.verify import CHECKS_TABLE, run_checks

    for dim in (3, 2):
        steps = tuple(s for s, _ in CHECKS_TABLE[dim][1])
        before = physics_3d.launches
        m = fmesh.cartesian(dim, (2,) * dim, (1.0,) * dim)
        h = Hydro(m, Options(problem=1, cg_tol=1e-14), device=dev)
        res = driver.run(h, t_final=0.6, vis_steps=10**6, check_steps=steps)
        run_checks(1, dim, res.norms)
        got = physics_3d.launches - before
        if dim == 3 and got == 0:
            raise AssertionError("3D goldens ran without the CUDA kernel")
        log(f"[4 goldens] {dim}D Sedov |e| at steps {steps}: "
            f"{[res.norms[s] for s in steps]} match CHECKS_TABLE at 1e-13 "
            f"(kernel launches {got})")


def drive(argv):
    """One main-path drive through the CLI with the launch count reset
    just before and read just after."""
    import contextlib
    import io

    from laghos_tpu_torch import cli
    from laghos_tpu_torch.ops.qphys import physics_3d

    buf = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    physics_3d.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        run = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = physics_3d.launches
    return run, launches, wall, buf.getvalue()


def phase_flagship():
    run, launches, wall, out = drive(FLAGSHIP)
    res, h, fom = run.result, run.hydro, run.fom
    step_ms = 1e3 * res.timings["total"] / res.steps
    drift = abs(res.energy_final - res.energy_init) / abs(res.energy_init)
    peak = torch.cuda.max_memory_allocated()
    for line in out.splitlines():
        if line.startswith("|") or "step" in line or "Energy" in line:
            log(f"[5 flagship] {line}")
    log(f"[5 flagship] NE {h.NE}, NQ {h.NQ}, quadrature points "
        f"{h.NE * h.NQ}, H1 dofs {h.ndof * 3}, L2 dofs {h.NE * h.ld}")
    log(f"[5 flagship] setup {run.setup_seconds:.3f} s, {res.steps} steps, "
        f"step_ms {step_ms:.3f} (timed run, fences per phase), "
        f"wall {wall:.3f} s")
    log(f"[5 flagship] FOM {fom['FOM']:.6g}, FOM1 {fom['FOM1']:.6g}, "
        f"FOM2 {fom['FOM2']:.6g}, FOM3 {fom['FOM3']:.6g}, T1 {fom['T1']:.4f} "
        f"T2 {fom['T2']:.4f} T3 {fom['T3']:.4f} s")
    t = res.timing_data.t
    log(f"[5 flagship] phase seconds over {res.steps} steps: "
        + ", ".join(f"{k} {v:.4f}" for k, v in t.items()))
    log(f"[5 flagship] CG iterations H1 {res.h1_iters} "
        f"({res.h1_iters / (2 * 3 * res.steps):.2f} per component solve), "
        f"L2 {res.l2_iters} ({res.l2_iters / (2 * res.steps):.2f} per "
        f"solve)")
    log(f"[5 flagship] final |e| {res.e_norm:.13e}, energy drift "
        f"{drift:.3e} (relative), peak device memory "
        f"{peak / 2**30:.3f} GiB")
    S = res.S
    finite = all(bool(torch.isfinite(S[k]).all()) for k in S)
    if not finite or not math.isfinite(res.e_norm):
        raise AssertionError("flagship state is not finite")
    if not drift <= 1e-12:
        raise AssertionError(f"RK2Avg energy drift {drift:.3e} > 1e-12")
    if launches != h.qupdate_calls or launches == 0:
        raise AssertionError(f"kernel launches {launches} != q-updates "
                             f"{h.qupdate_calls}")
    log(f"[5 flagship] kernel launches {launches} == q-updates "
        f"{h.qupdate_calls}")

    run32, launches32, wall32, _ = drive(FLAGSHIP_F32)
    if launches32 != run32.hydro.qupdate_calls or launches32 == 0:
        raise AssertionError("f32 run did not go through the kernel")
    e32 = run32.result.e_norm
    if not math.isfinite(e32):
        raise AssertionError("f32 flagship state is not finite")
    log(f"[5 flagship] f32: {run32.result.steps} steps in {wall32:.3f} s, "
        f"|e| {e32:.7e}, kernel launches {launches32}")
    return {torch.float64: launches, torch.float32: launches32}


def phase_repeat(dev):
    from laghos_tpu_torch import driver
    from laghos_tpu_torch.fem import mesh as fmesh
    from laghos_tpu_torch.hydro import Hydro, Options

    finals = []
    for _ in range(2):
        m = fmesh.cartesian(3, (2, 2, 2), (1.0, 1.0, 1.0))
        h = Hydro(m, Options(problem=1, cg_tol=1e-14), device=dev)
        finals.append(driver.run(h, t_final=0.6, vis_steps=10**6).S)
    same = all(torch.equal(finals[0][k], finals[1][k]) for k in finals[0])
    if not same:
        raise AssertionError("two runs differ")
    log("[6 repeat] two 3D Sedov rs0 runs: final states bitwise equal")


def main():
    t0 = time.perf_counter()
    dev = phase_device()
    phase_build()
    timed = phase_kernel(dev)
    phase_goldens(dev)
    launches = phase_flagship()
    phase_repeat(dev)
    kernels = [dict(name=f"qphys_{str(dt)[6:]}", route="cuda", source=SOURCE,
                    replaces=REPLACES[dt], launches=launches[dt],
                    **timed[dt])
               for dt in (torch.float64, torch.float32)]
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
