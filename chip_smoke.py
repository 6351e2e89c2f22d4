"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's paths (`laghos_tpu_torch`) through the entry points a
user calls, at the reference's 3D Sedov benchmark size, and checks them:

1. device: the card, its power limit, and the torch/CUDA/nvcc versions;
2. build of the hand-written CUDA kernels (csrc/qphys.cu, csrc/split.cu)
   from this checkout, one nvcc per source in parallel;
3. each kernel instance against its plain PyTorch version on the card, f64
   and f32, with inverted and NaN points mixed in, with launch times (warm,
   and with a cold L2: a 128 MiB buffer written before each launch): the
   element layout on the flagship mesh's gather-path q-data, the q-lattice
   and packed layouts on its q-lattice (2,097,152 points); the Ozaki split
   bit for bit at the six stage operands of an Ozaki mass apply of the
   flagship state (8 and 6 slices), at the flat operands of the flagship's
   L2 energy (NE, 8) and gather-path force (3 NE, 192) products, and on a
   mixed-magnitude operand with zero, NaN and Inf rows;
4. the reference's --checks goldens (3D and 2D Sedov) through the port's
   driver on the card, on the whole-lattice and on the gather path, and 3D
   Sedov through the Ozaki lattice path (at its gate, 3e-13);
5. the flagship runs: 3D Sedov, rs4, Q2-Q1, RK2Avg, f64 through the CLI on
   the lattice path (Jacobi, then --precond kron), with FOM, CG
   iterations, energy drift and peak memory; the gather path at the same
   size through `driver.run` for fewer steps, whose |e| must agree with
   the lattice run's; the ns4 shape (Q4-Q3, rs3) on the lattice path;
   short f32 runs of both paths; then the Ozaki mode (--ozaki) on the
   same shapes: flagship Jacobi and kron, ns4, and the gather path, each
   gated on drift and on |e| against the native lattice Jacobi run of this
   call.  The packed layout is on no time-stepping path (its `launches` is
   0 and its entry `on_path` false): its entry point is held, outside the
   counted runs, against the q-update of the final state of the f64 and
   the f32 lattice runs;
6. bitwise repeatability of two runs on the lattice path, two on the
   gather path and two on the Ozaki lattice path.

Each kernel's `bound_ms` is the larger of its bytes (every input read once,
every output written once) over 3.35 TB/s and its operations over the
card's peak for their type; `cold_ms` is its time with a cold L2, the one
its share of the bound is read against; `library_ms` is null, as no single
PyTorch call computes any of these functions.

Every phase raises on failure.  The last two lines are a JSON record of the
kernels and the JSON status line; neither is printed unless every phase
passed.  Exits non-zero without CUDA.
"""

from __future__ import annotations

import json
import math
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
FLAGSHIP_OZ = FLAGSHIP + ["--ozaki"]
FLAGSHIP_OZ_KRON = FLAGSHIP_KRON + ["--ozaki"]
NS4_OZ = NS4 + ["--ozaki"]
FLAGSHIP_F32 = ["-p", "1", "-dim", "3", "-rs", "4", "-ok", "2", "-ot", "1",
                "-s", "7", "-cgt", "2e-7", "-ms", "3", "--dtype", "f32",
                "-vs", "5", "-d", "cuda"]
# Options of the gather path (the default Options run the lattice path on
# these Cartesian meshes)
GATHER = dict(structured_el=False, lattice_ops=False, precond="jacobi")
GATHER_STEPS = 5           # accepted steps of the rs4 gather-path run
SOURCE = "laghos_tpu_torch/csrc/qphys.cu"
SPLIT_SOURCE = "laghos_tpu_torch/csrc/split.cu"
SPLIT_REPLACES = "laghos_tpu/ops/pallas_split.py:129"
F64, F32 = torch.float64, torch.float32
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, FP64 and FP32 rates outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {F64: 34e12, F32: 67e12}
# FP operations per q-point of the physics chain, counted from
# csrc/qphys.cu (det and adjugate, EOS, two 3x3 eigen-solves with their
# Jacobi sweeps, dt, stress): an estimate, not a measurement
QPHYS_OPS_PER_POINT = 1000
# beside it, what the card executes: static SASS instructions of the
# q-lattice viscous instance (f64, f32), the IEEE division and square-root
# sequences and their slow paths included, as phase 2 counts them in the
# built library (`kernels.sass_instructions`; H100 80GB HBM3, 700 W)
QPHYS_SASS_PER_POINT = {F64: 4038, F32: 3566}
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
    sass = kernels.sass_instructions(b.path)
    for code, dt in (("d", F64), ("f", F32)):
        n = [v for k, v in sass.items()
             if f"qphys_kernelI{code}Li1ELb1ELb0E" in k]
        if len(n) != 1:
            raise AssertionError(f"no q-lattice viscous {dt} instance in "
                                 f"the SASS of {b.path.name}")
        log(f"[2 build] q-lattice viscous {str(dt)[6:]} instance: {n[0]} "
            f"SASS instructions a point (QPHYS_SASS_PER_POINT "
            f"{QPHYS_SASS_PER_POINT[dt]}) against {QPHYS_OPS_PER_POINT} "
            "operations of the algorithm")


# ------------------------------------------------------- launch counts --
def _wrapper(layout):
    from laghos_tpu_torch.ops import qphys

    return getattr(qphys, LAYOUTS[layout][0])


def reset_counts():
    from laghos_tpu_torch.ops import omm

    for layout in LAYOUTS:
        _wrapper(layout).launches = 0
    omm.split_dyn.launches = 0


def read_counts():
    from laghos_tpu_torch.ops import omm

    out = {layout: _wrapper(layout).launches for layout in LAYOUTS}
    out["split"] = omm.split_dyn.launches
    return out


def bound(nbytes, ops, dtype):
    """(bound_ms, bound_by): the larger of the byte time at HBM bandwidth
    and the operation time at the card's peak for `dtype`."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


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
    from laghos_tpu_torch.timing import device_ms

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
    ms = device_ms(lambda: wrapper(*args, **kw))
    cold_ms = device_ms(lambda: wrapper(*args, **kw), cold=True)
    plain_ms = device_ms(lambda: plain(*args, **kw))
    b_ms, b_by = bound(_nbytes(args) + _nbytes(out_k),
                       QPHYS_OPS_PER_POINT * args[3].numel(), dtype)
    log(f"[3 kernel] {name}: kernel {ms:.4f} ms warm, {cold_ms:.4f} ms cold "
        f"L2, plain {plain_ms:.4f} ms (median of 20, N = "
        f"{args[3].numel()}); bound {b_ms:.4f} ms ({b_by}; "
        f"{QPHYS_OPS_PER_POINT} operations a point, the card runs "
        f"~{QPHYS_SASS_PER_POINT[dtype]} SASS instructions a point), "
        f"{100 * b_ms / cold_ms:.1f} % of it cold")
    return dict(max_abs_err=err, ms=ms, cold_ms=cold_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def mass_stage_operands(h, u):
    """The six operands the Ozaki mass apply of `h` splits (over axis 1)
    when it applies to the (3, ndof) field u: (3, 65, 65, 65) ... (3, 128,
    128, 128) ... at the flagship size."""
    from laghos_tpu_torch.ops import omm

    loz = h._lat_oz
    q = u.reshape((3,) + h._lat_dims)
    out = []
    for k in range(3):
        out.append(q)
        q = omm.tensordot(q, loz["fwdB"][k], 1)
    q = q * h._lat["Dq"][None]
    for k in range(3):
        out.append(q)
        q = omm.tensordot(q, loz["bwdB"][k], 1)
    return out


def _split_bitwise(A, S, what, axis=1):
    from laghos_tpu_torch.ops import omm

    k = omm.split_dyn(A, S, axis=axis)
    p = omm.split_dyn_plain(A, S, axis=axis)
    torch.cuda.synchronize()
    same = (torch.equal(k.cat, p.cat)
            and torch.equal(k.scale.view(torch.int64),
                            p.scale.view(torch.int64)))
    if not same:
        raise AssertionError(f"split kernel and plain twin differ: {what} "
                             f"S={S}")
    return k


def _time_split(A, what):
    """Kernel (warm and cold L2) and plain times of the 8-slice split of A
    over axis 1 (axis -1 for a 2D A), with its bound; logged."""
    from laghos_tpu_torch.ops import omm
    from laghos_tpu_torch.timing import device_ms

    axis = 1 if A.dim() > 2 else -1
    ms = device_ms(lambda: omm.split_dyn(A, 8, axis=axis))
    cold_ms = device_ms(lambda: omm.split_dyn(A, 8, axis=axis), cold=True)
    plain_ms = device_ms(lambda: omm.split_dyn_plain(A, 8, axis=axis))
    d = omm.split_dyn(A, 8, axis=axis)
    nbytes = _nbytes((A, d.cat, d.scale))
    nops = (4 + 8 + 2) * A.numel()  # csrc/split.cu: max, scaling, digits
    b_ms, b_by = bound(nbytes, nops, F64)
    k = A.shape[axis]
    log(f"[3 split] {what} {tuple(A.shape)} (k = {k}, {d.cat.shape[0]} "
        f"rows): bitwise equal at S = 8 and 6; S = 8 kernel {ms:.4f} ms "
        f"warm, {cold_ms:.4f} ms cold L2, plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}, {nbytes} B), {100 * b_ms / cold_ms:.1f} % "
        "of it cold")
    return dict(ms=ms, cold_ms=cold_ms, plain_ms=plain_ms), nbytes, nops


def phase_split(h):
    """The split kernel against its plain twin, bit for bit, at the six
    stage operands of an Ozaki mass apply of the flagship state (8 and 6
    slices), at the two flat (R2 = 1) operands of the flagship's
    `omm.matmul` calls (the L2 energy's (NE, 8) and the gather-path
    force's (3 NE, 192)), and on a mixed-magnitude operand with zero, NaN
    and Inf rows; times at 8 slices, warm and with a cold L2.  The
    kernels-line numbers are the sums over the six stages: the splits of
    one 8-slice mass apply."""
    rng = np.random.default_rng(1)
    ops = mass_stage_operands(h, _perturbed_velocity(h, rng))
    tot = dict(ms=0.0, cold_ms=0.0, plain_ms=0.0)
    nbytes = nops = 0
    for i, A in enumerate(ops):
        for S in (8, 6):
            d = _split_bitwise(A, S, f"stage {i}")
        mant, _ = torch.frexp(d.scale)
        if not bool((mant == 0.5).all()):
            raise AssertionError("split scales are not powers of two")
        t, nb, no = _time_split(A, f"stage {i}")
        for key in tot:
            tot[key] += t[key]
        nbytes += nb
        nops += no
    NE = h.NE
    for shape, what in (((NE, 8), "L2 energy operand"),
                        ((3 * NE, 192), "gather-path force operand")):
        A = torch.tensor(rng.standard_normal(shape), device=h.device)
        for S in (8, 6):
            _split_bitwise(A, S, what, axis=-1)
        _time_split(A, what)
    A = torch.tensor(rng.standard_normal((3, 17, 33)) * np.exp2(
        rng.integers(-30, 30, (3, 17, 33))), device=h.device)
    A[1, :, 5] = 0.0
    A[2, 4, 7] = float("nan")
    A[0, 9, 30] = float("inf")
    for S in (8, 6, 4):
        d = _split_bitwise(A, S, "mixed operand")
    nan_rows = int(torch.isnan(d.scale).sum())
    if nan_rows != 2:
        raise AssertionError(f"expected 2 NaN-scale rows, got {nan_rows}")
    log(f"[3 split] mixed-magnitude operand with zero, NaN and Inf rows: "
        f"bitwise equal at S = 8, 6, 4; NaN-scale rows {nan_rows}")
    b_ms, b_by = bound(nbytes, nops, F64)
    log(f"[3 split] one 8-slice mass apply's six splits: kernel "
        f"{tot['ms']:.4f} ms warm, {tot['cold_ms']:.4f} ms cold L2, plain "
        f"{tot['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}, {nbytes} "
        f"B), {100 * b_ms / tot['cold_ms']:.1f} % of it cold")
    return dict(max_abs_err=0.0, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, **tot)


def phase_kernel(dev):
    out = {}
    inp = element_inputs(flagship_hydro(dev, **GATHER))
    for dt in (F64, F32):
        out["element", dt] = compare("element", inp, dt)
    del inp
    h = flagship_hydro(dev, ozaki=True)
    if h._lat is None or h._lat_oz is None:
        raise AssertionError("the flagship mesh did not build the lattice")
    lat = lattice_inputs(h)
    pk = packed_inputs(h, lat[0])
    for dt in (F64, F32):
        out["lattice", dt] = compare("lattice", lat, dt)
    del lat
    for dt in (F64, F32):
        out["packed", dt] = compare("packed", pk, dt)
    del pk
    out["split"] = phase_split(h)
    del h
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ phase 4 --
def phase_goldens(dev):
    from laghos_tpu_torch import driver
    from laghos_tpu_torch.fem import mesh as fmesh
    from laghos_tpu_torch.hydro import Hydro, Options
    from laghos_tpu_torch.verify import (CHECKS_TABLE, OZAKI_CHECKS_EPS,
                                         run_checks)

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
    # the Ozaki lattice path: 3D only, at its own gate
    steps = tuple(s for s, _ in CHECKS_TABLE[3][1])
    m = fmesh.cartesian(3, (2,) * 3, (1.0,) * 3)
    h = Hydro(m, Options(problem=1, cg_tol=1e-14, ozaki=True), device=dev)
    reset_counts()
    res = driver.run(h, t_final=0.6, vis_steps=10**6, check_steps=steps)
    got = read_counts()
    run_checks(1, 3, res.norms, eps=OZAKI_CHECKS_EPS)
    if got["lattice"] != h.qupdate_calls or got["split"] == 0:
        raise AssertionError(f"3D Ozaki goldens: kernel launches {got}")
    log(f"[4 goldens] ozaki lattice 3D Sedov |e| at steps {steps}: "
        f"{[res.norms[s] for s in steps]} match CHECKS_TABLE at "
        f"{OZAKI_CHECKS_EPS:g} (kernel launches {got}, H1 CG "
        f"{res.h1_iters}, IR {h.ir_stats()})")


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


def _only(counts, layout, calls, what, ozaki=False):
    """The main-path run `what` launched the `layout` q-point kernel once
    per q-update and no other layout; the split kernel iff Ozaki."""
    got = {k: v for k, v in counts.items() if k != "split"}
    want = {k: (calls if k == layout else 0) for k in got}
    split_ok = counts["split"] > 0 if ozaki else counts["split"] == 0
    if got != want or calls == 0 or not split_ok:
        raise AssertionError(f"{what}: kernel launches {counts}, expected "
                             f"{want} and split launches "
                             f"{'> 0' if ozaki else '0'}")


def _ir_line(h):
    """CG-H1 inner sweeps and outers of an Ozaki lattice run."""
    st = h.ir_stats()
    return (f"CG-H1 IR: {st['solves']} solves, {st['outers']} outers "
            f"({st['outers'] / max(st['solves'], 1):.2f} per solve), "
            f"{st['outer_applies']} Ozaki residual applies, "
            f"{st['inner_sweeps']} f32 inner sweeps "
            f"({st['inner_sweeps'] / max(3 * st['solves'], 1):.2f} per "
            f"component solve)")


def flagship_run(argv, tag):
    run, counts, wall, out = drive(argv)
    res, h, fom = run.result, run.hydro, run.fom
    ozaki = h.oz is not None
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
        f"{h._lat_dims}, kron {'kron' in h._lat}, ozaki {ozaki}")
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
    if ozaki:
        log(f"{p} {_ir_line(h)}; split launches {counts['split']}")
    log(f"{p} final |e| {res.e_norm:.13e}, energy drift {drift:.3e} "
        f"(relative), peak device memory {peak / 2**30:.3f} GiB")
    S = res.S
    finite = all(bool(torch.isfinite(S[k]).all()) for k in S)
    if not finite or not math.isfinite(res.e_norm):
        raise AssertionError(f"{tag}: state is not finite")
    if not drift <= 1e-12:
        raise AssertionError(f"{tag}: RK2Avg energy drift {drift:.3e} > "
                             "1e-12")
    _only(counts, "lattice", h.qupdate_calls, tag, ozaki)
    log(f"{p} lattice kernel launches {counts['lattice']} == q-updates "
        f"{h.qupdate_calls}")
    return run, counts


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


def gather_run(dev, dtype, steps, cg_tol, **opt):
    """The gather path at the flagship size through driver.run."""
    from laghos_tpu_torch import driver

    t0 = time.perf_counter()
    h = flagship_hydro(dev, dtype, cg_tol=cg_tol, **GATHER, **opt)
    setup = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = driver.run(h, t_final=0.6, max_steps=steps - 1, vis_steps=5,
                     timing=True)
    torch.cuda.synchronize()
    counts = read_counts()
    what = f"gather {dtype}" + (" ozaki" if opt.get("ozaki") else "")
    _only(counts, "element", h.qupdate_calls, what, opt.get("ozaki", False))
    if res.steps != steps or not math.isfinite(res.e_norm):
        raise AssertionError(f"{what}: {res.steps} steps, |e| {res.e_norm}")
    return h, res, setup, counts


def gather_report(h, res, setup, counts, res_j, tag):
    """Log a gather-path run and hold its |e| at step GATHER_STEPS to the
    lattice Jacobi run's (`limit`: 1e-11 native, 1e-9 Ozaki)."""
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
    limit = 1e-9 if h.oz is not None else 1e-11
    log(f"[5 {tag}] setup {setup:.3f} s, {res.steps} steps, step_ms "
        f"{step_ms:.3f} (timed), phase seconds "
        + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
        + f"; FOM {fom['FOM']:.6g}, FOM1 {fom['FOM1']:.6g}, FOM2 "
        f"{fom['FOM2']:.6g}, FOM3 {fom['FOM3']:.6g}"
        + f"; CG H1 {res.h1_iters} "
        f"({res.h1_iters / (2 * 3 * res.steps):.2f} per component solve), "
        f"L2 {res.l2_iters} ({res.l2_iters / (2 * res.steps):.2f} per "
        f"solve); energy drift {drift:.3e}; peak device memory "
        f"{peak / 2**30:.3f} GiB; split launches {counts['split']}")
    log(f"[5 {tag}] |e| at step {GATHER_STEPS}: {res.norms[GATHER_STEPS]!r}"
        f" vs lattice Jacobi {res_j.norms[GATHER_STEPS]!r}: rel {rel:.3e} "
        f"(limit {limit:g}); element kernel launches "
        f"{counts['element']} == q-updates {h.qupdate_calls}")
    if not rel <= limit:
        raise AssertionError(f"{tag}: gather and lattice paths disagree in "
                             "|e|")
    if not drift <= 1e-12:
        raise AssertionError(f"{tag}: RK2Avg energy drift {drift:.3e} > "
                             "1e-12")


def _against(res, ref, tag, what):
    """Hold an Ozaki run's final |e| within 1e-9 (relative) of the native
    run `ref` over the same steps."""
    if res.steps != ref.steps:
        raise AssertionError(f"{tag}: {res.steps} steps against {ref.steps} "
                             f"of {what}")
    rel = abs(res.e_norm - ref.e_norm) / ref.e_norm
    log(f"[5 {tag}] |e| after {res.steps} steps vs {what}: rel {rel:.3e} "
        "(limit 1e-9)")
    if not rel <= 1e-9:
        raise AssertionError(f"{tag}: |e| departs from {what}")


def phase_flagship(dev):
    launches = {}

    def add(key, n):
        launches[key] = launches.get(key, 0) + n

    run_j, counts = flagship_run(FLAGSHIP, "flagship")
    add(("lattice", F64), counts["lattice"])
    res_j = run_j.result
    packed_check(run_j.hydro, res_j.S, "flagship")
    del run_j
    run_k, counts = flagship_run(FLAGSHIP_KRON, "kron")
    res_k = run_k.result
    del run_k
    add(("lattice", F64), counts["lattice"])
    if res_k.steps != res_j.steps:
        raise AssertionError("kron and Jacobi runs took different steps")
    rel_k = abs(res_k.e_norm - res_j.e_norm) / res_j.e_norm
    log(f"[5 kron] |e| after {res_k.steps} steps vs the Jacobi run: rel "
        f"{rel_k:.3e}; H1 CG iterations {res_k.h1_iters} vs "
        f"{res_j.h1_iters}")

    h, res, setup, counts = gather_run(dev, F64, GATHER_STEPS, 1e-11)
    add(("element", F64), counts["element"])
    gather_report(h, res, setup, counts, res_j, "gather")
    del h, res

    run_4, counts = flagship_run(NS4, "ns4")
    add(("lattice", F64), counts["lattice"])
    res_4 = run_4.result
    del run_4

    run32, counts, wall32, _ = drive(FLAGSHIP_F32)
    _only(counts, "lattice", run32.hydro.qupdate_calls, "f32 lattice")
    add(("lattice", F32), counts["lattice"])
    e32 = run32.result.e_norm
    if not math.isfinite(e32):
        raise AssertionError("f32 flagship state is not finite")
    log(f"[5 f32] lattice: {run32.result.steps} steps in {wall32:.3f} s, "
        f"|e| {e32:.7e}, lattice kernel launches {counts['lattice']}")
    packed_check(run32.hydro, run32.result.S, "f32")
    del run32
    h32, res32, _, counts = gather_run(dev, F32, 2, 2e-7)
    add(("element", F32), counts["element"])
    log(f"[5 f32] gather: {res32.steps} steps, |e| {res32.e_norm:.7e}, "
        f"element kernel launches {counts['element']}")
    del h32, res32
    torch.cuda.empty_cache()

    # the Ozaki mode on the same shapes, held to the native runs above
    for argv, tag, ref, what in (
            (FLAGSHIP_OZ, "ozaki", res_j, "the native Jacobi run"),
            (FLAGSHIP_OZ_KRON, "ozaki kron", res_j, "the native Jacobi run"),
            (NS4_OZ, "ozaki ns4", res_4, "the native ns4 run")):
        run_o, counts = flagship_run(argv, tag)
        add(("lattice", F64), counts["lattice"])
        add("split", counts["split"])
        _against(run_o.result, ref, tag, what)
        del run_o
        torch.cuda.empty_cache()
    h, res, setup, counts = gather_run(dev, F64, GATHER_STEPS, 1e-11,
                                       ozaki=True)
    add(("element", F64), counts["element"])
    add("split", counts["split"])
    gather_report(h, res, setup, counts, res_j, "ozaki gather")
    del h, res
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ phase 6 --
def phase_repeat(dev):
    from laghos_tpu_torch import driver
    from laghos_tpu_torch.fem import mesh as fmesh
    from laghos_tpu_torch.hydro import Hydro, Options

    for path, rs, kw in (("lattice", 0, dict(t_final=0.6)),
                         ("lattice", 2, dict(t_final=0.6, max_steps=9)),
                         ("gather", 0, dict(t_final=0.6)),
                         ("ozaki lattice", 0, dict(t_final=0.6)),
                         ("ozaki lattice", 2, dict(t_final=0.6,
                                                   max_steps=9))):
        opt = {"gather": GATHER, "lattice": {},
               "ozaki lattice": {"ozaki": True}}[path]
        finals = []
        for _ in range(2):
            m = fmesh.cartesian(3, (2, 2, 2), (1.0, 1.0, 1.0))
            for _ in range(rs):
                m = fmesh.uniform_refine(m)
            h = Hydro(m, Options(problem=1, cg_tol=1e-14, **opt), device=dev)
            if (h._lat is not None) != (path != "gather"):
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
    kernels.append(dict(name="split_f64", route="cuda", source=SPLIT_SOURCE,
                        replaces=SPLIT_REPLACES,
                        launches=launches.get("split", 0), on_path=True,
                        **timed["split"]))
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
