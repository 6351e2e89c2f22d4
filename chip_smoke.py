"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's paths (`laghos_tpu_torch`) through the entry points a
user calls, at the reference's 3D Sedov benchmark size, and checks them:

1. device: the card, its power limit, and the torch/CUDA/nvcc versions;
2. build of the hand-written CUDA kernels (csrc/qphys.cu) from this
   checkout;
3. each kernel instance against its plain PyTorch version on the card, f64
   and f32, with inverted and NaN points mixed in, with launch times: the
   element layout on the flagship mesh's gather-path q-data, the q-lattice
   and packed layouts on its q-lattice (2,097,152 points);
4. the reference's --checks goldens (3D and 2D Sedov) through the port's
   driver on the card, on the whole-lattice and on the gather path;
5. the flagship runs: 3D Sedov, rs4, Q2-Q1, RK2Avg, f64 through the CLI on
   the lattice path (Jacobi, then --precond kron), with FOM, CG
   iterations, energy drift and peak memory; the gather path at the same
   size through `driver.run` for fewer steps, whose |e| must agree with
   the lattice run's; the ns4 shape (Q4-Q3, rs3) on the lattice path;
   short f32 runs of both paths.  The packed layout is on no
   time-stepping path (its `launches` is 0 and its entry `on_path` false):
   its entry point is held, outside the counted runs, against the
   q-update of the final state of the f64 and the f32 lattice runs;
6. bitwise repeatability of two runs on the lattice path and two on the
   gather path.

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
FLAGSHIP_KRON = FLAGSHIP + ["--precond", "kron"]
# the JAX package's ns4 shape (Q4-Q3 at rs3), a few steps
NS4 = ["-p", "1", "-dim", "3", "-rs", "3", "-ok", "4", "-ot", "3", "-s", "7",
       "-cgt", "1e-11", "-ms", "4", "-f", "-vs", "5", "-d", "cuda"]
FLAGSHIP_F32 = ["-p", "1", "-dim", "3", "-rs", "4", "-ok", "2", "-ot", "1",
                "-s", "7", "-cgt", "2e-7", "-ms", "3", "--dtype", "f32",
                "-vs", "5", "-d", "cuda"]
# Options of the gather path (the default Options run the lattice path on
# these Cartesian meshes)
GATHER = dict(structured_el=False, lattice_ops=False, precond="jacobi")
GATHER_STEPS = 5           # accepted steps of the rs4 gather-path run
SOURCE = "laghos_tpu_torch/csrc/qphys.cu"
F64, F32 = torch.float64, torch.float32
# layout -> (wrapper in ops/qphys, {dtype: the TPU kernel it replaces})
LAYOUTS = {
    "element": ("physics_3d", {F64: "laghos_tpu/ops/pallas_df64.py:132",
                               F32: "laghos_tpu/ops/pallas_qphys.py:211"}),
    "lattice": ("physics_3d_lattice",
                {F64: "laghos_tpu/ops/pallas_qphys.py:149",
                 F32: "laghos_tpu/ops/pallas_qphys.py:149"}),
    "packed": ("physics_3d_packed",
               {F64: "laghos_tpu/ops/pallas_qphys.py:97",
                F32: "laghos_tpu/ops/pallas_qphys.py:97"}),
}
# kernel vs plain version on the card, relative to max|sJit| (and max|visc|
# for the packed layout).  Both run the same operations; they differ only
# where nvcc contracts a*b+c into FMA and the plain version rounds twice.
# f64: ~1e-16 observed, 1e-12 asked.  f32: ~1e-9 observed on an H100 (the
# f32 eigen-solve of the strain rate can amplify an ulp of difference);
# 1e-5 is about 80 f32 ulps of max|sJit|.
TOL = {F64: 1e-12, F32: 1e-5}


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


# ------------------------------------------------------- launch counts --
def _wrapper(layout):
    from laghos_tpu_torch.ops import qphys

    return getattr(qphys, LAYOUTS[layout][0])


def reset_counts():
    for layout in LAYOUTS:
        _wrapper(layout).launches = 0


def read_counts():
    return {layout: _wrapper(layout).launches for layout in LAYOUTS}


# ------------------------------------------------------------ phase 3 --
def flagship_hydro(device, dtype=F64, **opt):
    from laghos_tpu_torch.fem import mesh as fmesh
    from laghos_tpu_torch.hydro import Hydro, Options

    m = fmesh.cartesian(3, (2, 2, 2), (1.0, 1.0, 1.0))
    for _ in range(4):
        m = fmesh.uniform_refine(m)
    opt = {"problem": 1, "ode_solver": 7, "cg_tol": 1e-11, **opt}
    return Hydro(m, Options(**opt), dtype=dtype, device=device)


def _perturbed_velocity(h, rng):
    dv = torch.tensor(rng.normal(size=tuple(h.S0["v"].shape)) * 0.1,
                      dtype=h.dtype, device=h.device)
    return h.S0["v"] + dv


def element_inputs(h, seed=0):
    """Element-layout q-data of the gather-path `h` at t=0 with the
    velocity perturbed by a seeded field (so the viscous branch is
    active), and a few inverted and NaN points."""
    from laghos_tpu_torch.ops import qupdate as qop
    from laghos_tpu_torch.ops import tensor as top

    rng = np.random.default_rng(seed)
    S = h.S0
    v = _perturbed_velocity(h, rng)
    x_e, v_e = h._gather_e(S["x"]), h._gather_e(v)
    J9 = qop._grad9(x_e, h.tables["H1B"], h.tables["H1G"], h.nd1, h.NQ)
    dV9 = qop._grad9(v_e, h.tables["H1B"], h.tables["H1G"], h.nd1, h.NQ)
    et = S["e"].reshape((h.NE,) + (h.l1d,) * 3)
    e_q = top.eval_values(et, h.tables["L2B"], 3).reshape(h.NE, h.NQ)
    e_q = e_q + 0.5             # nonzero pressure everywhere
    _inject(rng, J9.reshape(9, -1), e_q.reshape(-1))
    args = [J9.contiguous(), dV9.contiguous(), h.Jac0inv_t, e_q.contiguous(),
            h.rho0DetJ0w_t, h.gamma_t, h.tables["Winv"]]
    return args, dict(h0_e=h.h0)


def _inject(rng, J9flat, e_flat):
    """4 inverted, 2 NaN-geometry and 2 NaN-energy points."""
    pts = torch.as_tensor(rng.choice(e_flat.numel(), size=8, replace=False),
                          device=e_flat.device)
    J9flat[:, pts[:4]] *= -1.0                    # detJ < 0
    J9flat[4, pts[4:6]] = float("nan")            # NaN geometry
    e_flat[pts[6:]] = float("nan")                # NaN energy


def _qlattice_args(h, x, v, e):
    """The lattice-layout arguments of the q-update of the lattice-path
    `h` at the state (x, v, e)."""
    from laghos_tpu_torch.ops import lattice as lop

    lat, dims = h._lat, h._lat_dims
    J9 = torch.stack(lop.grad9_lattice(x.reshape((3,) + dims), lat["Ts"],
                                       lat["Tg"]))
    dV9 = torch.stack(lop.grad9_lattice(v.reshape((3,) + dims), lat["Ts"],
                                        lat["Tg"]))
    e_q = lop.energy_qlattice(e, h._edims, h.tables, 3)
    return [J9, dV9, lat["J0i9"], e_q, lat["rw"], lat["gam"], lat["winv"]]


def lattice_inputs(h, seed=0):
    """q-lattice-layout q-data of the lattice-path `h`, perturbed and
    injected as `element_inputs`."""
    rng = np.random.default_rng(seed)
    S = h.S0
    args = _qlattice_args(h, S["x"], _perturbed_velocity(h, rng), S["e"])
    args[3] = args[3] + 0.5
    _inject(rng, args[0].reshape(9, -1), args[3].reshape(-1))
    return args, dict(h0=h.h0)


def packed_inputs(h, lattice_args):
    """The same q-data in the packed layout: (NE, NQ, 3, 3) per field."""
    from laghos_tpu_torch.ops import lattice as lop

    J9, dV9, J0i9, e_q, rw = lattice_args[:5]

    def eq(a):
        return lop.qlattice_to_eq(a, h._edims, h.nq1)

    def packed(A9):
        return torch.stack([eq(a) for a in A9], dim=-1).reshape(
            h.NE, h.NQ, 3, 3).contiguous()

    args = [packed(J9), packed(dV9), packed(J0i9), eq(e_q).contiguous(),
            eq(rw).contiguous(), h.gamma_t, h.tables["W"]]
    return args, dict(h0=h.h0)


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


def _max_err(k, p, what, dtype):
    nan_k, nan_p = torch.isnan(k), torch.isnan(p)
    if not torch.equal(nan_k, nan_p):
        raise AssertionError(f"{dtype}: NaN patterns of {what} differ")
    fin = ~nan_p
    return float((k[fin] - p[fin]).abs().max()), float(p[fin].abs().max())


def compare(layout, inputs, dtype):
    """Kernel against plain version on the card for one layout and dtype;
    returns the kernels-line numbers."""
    from laghos_tpu_torch.ops import qphys

    wrapper = _wrapper(layout)
    plain = getattr(qphys, LAYOUTS[layout][0] + "_plain")
    base, extra = inputs
    args = [a.to(dtype) for a in base]
    kw = dict(extra, h1order=2.0, cfl=0.5, use_viscosity=True,
              use_vorticity=False)
    out_k, out_p = wrapper(*args, **kw), plain(*args, **kw)
    torch.cuda.synchronize()
    err, scale = _max_err(out_k[0], out_p[0], "sJit", dtype)
    dk, dp = out_k[1], out_p[1]
    zk, zp = dk == 0, dp == 0
    if not torch.equal(zk, zp):
        raise AssertionError(f"{layout} {dtype}: dtq == 0 masks differ "
                             f"({int(zk.sum())} vs {int(zp.sum())})")
    good = dp > 0
    dmin_k, dmin_p = float(dk[good].min()), float(dp[good].min())
    drel = abs(dmin_k - dmin_p) / dmin_p
    tol = TOL[dtype]
    name = f"{layout} {str(dtype)[6:]}"
    msg = (f"[3 kernel] {name}: max|dsJit| {err:.3e} = {err / scale:.3e} x "
           f"max|sJit| (tol {tol:g}); dtq.min rel diff {drel:.3e}; "
           f"zero-dt points {int(zp.sum())}")
    ok = err <= tol * scale and drel <= tol
    if layout == "packed":
        verr, vscale = _max_err(out_k[2], out_p[2], "visc", dtype)
        msg += f"; max|dvisc| {verr / vscale:.3e} x max|visc|"
        ok = ok and verr <= tol * vscale
        err = max(err, verr)
    log(msg)
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with the plain "
                             "version")
    if int(zp.sum()) < 8:
        raise AssertionError("injected inverted/NaN points did not reach "
                             "dt = 0")
    ms = time_ms(lambda: wrapper(*args, **kw))
    plain_ms = time_ms(lambda: plain(*args, **kw))
    log(f"[3 kernel] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
        f"(median of 20, N = {args[3].numel()})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def phase_kernel(dev):
    out = {}
    inp = element_inputs(flagship_hydro(dev, **GATHER))
    for dt in (F64, F32):
        out["element", dt] = compare("element", inp, dt)
    del inp
    h = flagship_hydro(dev)
    if h._lat is None:
        raise AssertionError("the flagship mesh did not build the lattice")
    lat = lattice_inputs(h)
    pk = packed_inputs(h, lat[0])
    for dt in (F64, F32):
        out["lattice", dt] = compare("lattice", lat, dt)
    del lat
    for dt in (F64, F32):
        out["packed", dt] = compare("packed", pk, dt)
    del pk, h
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ phase 4 --
def phase_goldens(dev):
    from laghos_tpu_torch import driver
    from laghos_tpu_torch.fem import mesh as fmesh
    from laghos_tpu_torch.hydro import Hydro, Options
    from laghos_tpu_torch.verify import CHECKS_TABLE, run_checks

    for path, opt, layout in (("lattice", {}, "lattice"),
                              ("gather", GATHER, "element")):
        for dim in (3, 2):
            steps = tuple(s for s, _ in CHECKS_TABLE[dim][1])
            m = fmesh.cartesian(dim, (2,) * dim, (1.0,) * dim)
            h = Hydro(m, Options(problem=1, cg_tol=1e-14, **opt), device=dev)
            if (h._lat is not None) != (path == "lattice"):
                raise AssertionError(f"{path} goldens built the wrong path")
            reset_counts()
            res = driver.run(h, t_final=0.6, vis_steps=10**6,
                             check_steps=steps)
            got = read_counts()
            run_checks(1, dim, res.norms)
            if dim == 3 and got[layout] != h.qupdate_calls:
                raise AssertionError(f"3D {path} goldens: {layout} kernel "
                                     f"launches {got}")
            log(f"[4 goldens] {path} {dim}D Sedov |e| at steps {steps}: "
                f"{[res.norms[s] for s in steps]} match CHECKS_TABLE at "
                f"1e-13 (kernel launches {got}, H1 CG {res.h1_iters})")


# ------------------------------------------------------------ phase 5 --
def drive(argv):
    """One drive through the CLI with the launch counts reset just before
    and read just after."""
    import contextlib
    import io

    from laghos_tpu_torch import cli

    buf = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        run = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return run, read_counts(), wall, buf.getvalue()


def _only(counts, layout, calls, what):
    want = {k: (calls if k == layout else 0) for k in counts}
    if counts != want or calls == 0:
        raise AssertionError(f"{what}: kernel launches {counts}, expected "
                             f"{want}")


def flagship_run(argv, tag):
    run, counts, wall, out = drive(argv)
    res, h, fom = run.result, run.hydro, run.fom
    if h._lat is None:
        raise AssertionError(f"{tag}: the CLI did not take the lattice path")
    step_ms = 1e3 * res.timings["total"] / res.steps
    drift = abs(res.energy_final - res.energy_init) / abs(res.energy_init)
    peak = torch.cuda.max_memory_allocated()
    p = f"[5 {tag}]"
    for line in out.splitlines():
        if line.startswith("|") or "step" in line or "Energy" in line:
            log(f"{p} {line}")
    log(f"{p} NE {h.NE}, NQ {h.NQ}, quadrature points {h.NE * h.NQ}, H1 "
        f"dofs {h.ndof * 3}, L2 dofs {h.NE * h.ld}, lattice "
        f"{h._lat_dims}, kron {'kron' in h._lat}")
    log(f"{p} setup {run.setup_seconds:.3f} s, {res.steps} steps, "
        f"step_ms {step_ms:.3f} (timed run, fences per phase), "
        f"wall {wall:.3f} s")
    log(f"{p} FOM {fom['FOM']:.6g}, FOM1 {fom['FOM1']:.6g}, "
        f"FOM2 {fom['FOM2']:.6g}, FOM3 {fom['FOM3']:.6g}, T1 {fom['T1']:.4f} "
        f"T2 {fom['T2']:.4f} T3 {fom['T3']:.4f} s")
    t = res.timing_data.t
    log(f"{p} phase seconds over {res.steps} steps: "
        + ", ".join(f"{k} {v:.4f}" for k, v in t.items()))
    log(f"{p} CG iterations H1 {res.h1_iters} "
        f"({res.h1_iters / (2 * 3 * res.steps):.2f} per component solve), "
        f"L2 {res.l2_iters} ({res.l2_iters / (2 * res.steps):.2f} per "
        f"solve)")
    log(f"{p} final |e| {res.e_norm:.13e}, energy drift {drift:.3e} "
        f"(relative), peak device memory {peak / 2**30:.3f} GiB")
    S = res.S
    finite = all(bool(torch.isfinite(S[k]).all()) for k in S)
    if not finite or not math.isfinite(res.e_norm):
        raise AssertionError(f"{tag}: state is not finite")
    if not drift <= 1e-12:
        raise AssertionError(f"{tag}: RK2Avg energy drift {drift:.3e} > "
                             "1e-12")
    _only(counts, "lattice", h.qupdate_calls, tag)
    log(f"{p} lattice kernel launches {counts['lattice']} == q-updates "
        f"{h.qupdate_calls}")
    return run, counts["lattice"]


def packed_check(h, S, tag):
    """The packed layout runs on no time-stepping path (the JAX package
    calls its kernel only from its tests).  Hold its entry point,
    `ops/qphys.physics_3d_packed`, against the lattice q-update of the
    final state S of a lattice-path run.  A comparison, not a main-path
    run: its launches are not counted."""
    from laghos_tpu_torch.ops import lattice as lop
    from laghos_tpu_torch.ops import qphys

    sJ_lat, dt_lat = h._qupdate(S)
    args, extra = packed_inputs(h, _qlattice_args(h, S["x"], S["v"],
                                                  S["e"]))
    sJ, dtq, visc = qphys.physics_3d_packed(
        *args, **extra, h1order=float(h.opt.order_v), cfl=h.opt.cfl,
        use_viscosity=h.use_visc, use_vorticity=h.use_vort)
    sJ9 = torch.stack([lop.eq_to_qlattice(a, h._edims, h.nq1)
                       for a in sJ.reshape(h.NE, h.NQ, 9).unbind(-1)])
    tol = TOL[h.dtype]
    err = float((sJ9 - sJ_lat).abs().max() / sJ_lat.abs().max())
    drel = abs(float(dtq.min()) - float(dt_lat)) / float(dt_lat)
    log(f"[5 {tag}] packed entry point on the final state: sJit vs the "
        f"lattice q-update {err:.3e} x max|sJit|, dt rel diff {drel:.3e} "
        f"(tol {tol:g}); max visc {float(visc.max()):.6e}")
    if not (err <= tol and drel <= tol and bool(torch.isfinite(visc).all())):
        raise AssertionError(f"{tag}: the packed layout disagrees with the "
                             "lattice q-update")


def gather_run(dev, dtype, steps, cg_tol):
    """The gather path at the flagship size through driver.run."""
    from laghos_tpu_torch import driver

    t0 = time.perf_counter()
    h = flagship_hydro(dev, dtype, cg_tol=cg_tol, **GATHER)
    setup = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = driver.run(h, t_final=0.6, max_steps=steps - 1, vis_steps=5,
                     timing=True)
    torch.cuda.synchronize()
    counts = read_counts()
    _only(counts, "element", h.qupdate_calls, f"gather {dtype}")
    if res.steps != steps or not math.isfinite(res.e_norm):
        raise AssertionError(f"gather {dtype}: {res.steps} steps, |e| "
                             f"{res.e_norm}")
    return h, res, setup, counts["element"]


def phase_flagship(dev):
    launches = {}
    run_j, launches["lattice", F64] = flagship_run(FLAGSHIP, "flagship")
    res_j = run_j.result
    packed_check(run_j.hydro, res_j.S, "flagship")
    del run_j
    run_k, n = flagship_run(FLAGSHIP_KRON, "kron")
    res_k = run_k.result
    del run_k
    launches["lattice", F64] += n
    if res_k.steps != res_j.steps:
        raise AssertionError("kron and Jacobi runs took different steps")
    rel_k = abs(res_k.e_norm - res_j.e_norm) / res_j.e_norm
    log(f"[5 kron] |e| after {res_k.steps} steps vs the Jacobi run: rel "
        f"{rel_k:.3e}; H1 CG iterations {res_k.h1_iters} vs "
        f"{res_j.h1_iters}")

    h, res, setup, launches["element", F64] = gather_run(
        dev, F64, GATHER_STEPS, 1e-11)
    from laghos_tpu_torch.timing import print_timing

    t = res.timing_data.t
    step_ms = 1e3 * res.timings["total"] / res.steps
    peak = torch.cuda.max_memory_allocated()
    fom = print_timing(res.timing_data, steps=2 * res.steps,
                       H1_dofs=3 * h.ndof, L2_dofs=h.NE * h.ld, NQ=h.NQ,
                       NE=h.NE, p_assembly=True, dim=3, fom_table=False,
                       out=lambda *a: None)
    rel = abs(res.norms[GATHER_STEPS] - res_j.norms[GATHER_STEPS]) \
        / res_j.norms[GATHER_STEPS]
    drift = abs(res.energy_final - res.energy_init) / abs(res.energy_init)
    log(f"[5 gather] setup {setup:.3f} s, {res.steps} steps, step_ms "
        f"{step_ms:.3f} (timed), phase seconds "
        + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
        + f"; FOM {fom['FOM']:.6g}, FOM1 {fom['FOM1']:.6g}, FOM2 "
        f"{fom['FOM2']:.6g}, FOM3 {fom['FOM3']:.6g}"
        + f"; CG H1 {res.h1_iters} "
        f"({res.h1_iters / (2 * 3 * res.steps):.2f} per component solve), "
        f"L2 {res.l2_iters} ({res.l2_iters / (2 * res.steps):.2f} per "
        f"solve); energy drift {drift:.3e}; peak device memory "
        f"{peak / 2**30:.3f} GiB")
    log(f"[5 gather] |e| at step {GATHER_STEPS}: {res.norms[GATHER_STEPS]!r}"
        f" vs lattice {res_j.norms[GATHER_STEPS]!r}: rel {rel:.3e} "
        f"(limit 1e-11); element kernel launches "
        f"{launches['element', F64]} == q-updates {h.qupdate_calls}")
    if not rel <= 1e-11:
        raise AssertionError("gather and lattice paths disagree in |e|")
    if not drift <= 1e-12:
        raise AssertionError(f"gather: RK2Avg energy drift {drift:.3e} > "
                             "1e-12")
    del h, res

    _, launches_ns4 = flagship_run(NS4, "ns4")
    launches["lattice", F64] += launches_ns4

    run32, counts, wall32, _ = drive(FLAGSHIP_F32)
    _only(counts, "lattice", run32.hydro.qupdate_calls, "f32 lattice")
    launches["lattice", F32] = counts["lattice"]
    e32 = run32.result.e_norm
    if not math.isfinite(e32):
        raise AssertionError("f32 flagship state is not finite")
    log(f"[5 f32] lattice: {run32.result.steps} steps in {wall32:.3f} s, "
        f"|e| {e32:.7e}, lattice kernel launches {counts['lattice']}")
    packed_check(run32.hydro, run32.result.S, "f32")
    del run32
    h32, res32, _, launches["element", F32] = gather_run(dev, F32, 2, 2e-7)
    log(f"[5 f32] gather: {res32.steps} steps, |e| {res32.e_norm:.7e}, "
        f"element kernel launches {launches['element', F32]}")
    del h32, res32
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ phase 6 --
def phase_repeat(dev):
    from laghos_tpu_torch import driver
    from laghos_tpu_torch.fem import mesh as fmesh
    from laghos_tpu_torch.hydro import Hydro, Options

    for path, rs, kw in (("lattice", 0, dict(t_final=0.6)),
                         ("lattice", 2, dict(t_final=0.6, max_steps=9)),
                         ("gather", 0, dict(t_final=0.6))):
        opt = GATHER if path == "gather" else {}
        finals = []
        for _ in range(2):
            m = fmesh.cartesian(3, (2, 2, 2), (1.0, 1.0, 1.0))
            for _ in range(rs):
                m = fmesh.uniform_refine(m)
            h = Hydro(m, Options(problem=1, cg_tol=1e-14, **opt), device=dev)
            if (h._lat is not None) != (path == "lattice"):
                raise AssertionError(f"{path} repeat runs built the wrong "
                                     "path")
            finals.append(driver.run(h, vis_steps=10**6, **kw))
        same = all(torch.equal(finals[0].S[k], finals[1].S[k])
                   for k in finals[0].S)
        if not same:
            raise AssertionError(f"two {path}-path rs{rs} runs differ")
        log(f"[6 repeat] two 3D Sedov rs{rs} {path}-path runs "
            f"({finals[0].steps} steps): final states bitwise equal")


def main():
    t0 = time.perf_counter()
    dev = phase_device()
    phase_build()
    timed = phase_kernel(dev)
    phase_goldens(dev)
    launches = phase_flagship(dev)
    phase_repeat(dev)
    # launches come from the main-path runs only; the packed layout is on
    # none of them
    kernels = [dict(name=f"qphys_{layout}_{str(dt)[6:]}", route="cuda",
                    source=SOURCE, replaces=LAYOUTS[layout][1][dt],
                    launches=launches.get((layout, dt), 0),
                    on_path=layout != "packed", **timed[layout, dt])
               for layout in LAYOUTS for dt in (F64, F32)]
    idle = [k["name"] for k in kernels if k["on_path"] and not k["launches"]]
    if idle:
        raise AssertionError(f"kernels of the path never launched: {idle}")
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
