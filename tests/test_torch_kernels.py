"""The hand-written CUDA kernels (element, q-lattice and packed layouts of
csrc/qphys.cu, f64 and f32; the Ozaki split of csrc/split.cu; the element
PA mass apply of csrc/mass.cu and the lattice H1 mass apply of
csrc/lattice_mass.cu, f64 and f32) against their plain PyTorch versions,
on the card; the Ozaki int8 products of
ops/omm.py and the full-assembly mass product of ops/assemble.py on the
card against the same products on the CPU; the CG chain of csrc/cg.cu
against the eager iteration and against the JAX package's solves kept in
tests/data (`cg_reference`).  This file imports neither JAX nor
`laghos_tpu`, so it also runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Without a CUDA card every test skips.
"""

import cg_reference
import numpy as np
import pytest
import torch

from laghos_tpu_torch.fem import mesh as tmesh
from laghos_tpu_torch.hydro import Hydro, Options
from laghos_tpu_torch.ops import lattice as tlat
from laghos_tpu_torch.ops import mass as tmass
from laghos_tpu_torch.ops import omm
from laghos_tpu_torch.ops import qphys
from laghos_tpu_torch.ops import qupdate as tqup
from laghos_tpu_torch.ops import tensor as ttensor


@pytest.fixture(scope="module")
def qdata():
    """3D q-data on the card: the Sedov mesh refined once, its state
    perturbed by a numpy-seeded field, with inverted and NaN points."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    m = tmesh.uniform_refine(tmesh.cartesian(3, (2, 2, 2), (1.0, 1.0, 1.0)))
    h = Hydro(m, Options(problem=1, structured_el=False, lattice_ops=False,
                         precond="jacobi"), device="cuda")
    rng = np.random.default_rng(0)
    S = h.S0
    v = S["v"] + torch.tensor(0.1 * rng.normal(size=tuple(S["v"].shape)),
                              dtype=h.dtype, device=h.device)
    t = h.tables
    J9 = tqup._grad9(h._gather_e(S["x"]), t["H1B"], t["H1G"], h.nd1, h.NQ)
    dV9 = tqup._grad9(h._gather_e(v), t["H1B"], t["H1G"], h.nd1, h.NQ)
    et = S["e"].reshape((h.NE,) + (h.l1d,) * 3)
    e_q = ttensor.eval_values(et, t["L2B"], 3).reshape(h.NE, h.NQ) + 0.5
    J9[:, 3, 5] *= -1.0              # detJ < 0
    J9[:, 10, 0] *= -1.0
    J9[4, 20, 7] = float("nan")      # NaN geometry
    e_q[30, 11] = float("nan")       # NaN energy
    return h, [J9.contiguous(), dV9.contiguous(), h.Jac0inv_t,
               e_q.contiguous(), h.rho0DetJ0w_t, h.gamma_t, t["Winv"]]


# Point counts of the ragged-edge cases: (NE, NQ) with N = NE * NQ in
# {1, 127, 129 (one tile of 128 points + 1), 2,097,157}; None is the
# fixture's own q-data.
SIZES = [None, (1, 1), (1, 127), (3, 43), (39569, 53)]


def _cycle(A, n):
    """The first n points of A (..., N0) repeated along its last axis."""
    idx = torch.arange(n, device=A.device) % A.shape[-1]
    return A[..., idx].contiguous()


def _sized(inputs, layout, size, dtype):
    """Inputs of NE * NQ points cut from the fixture's (`layout`'s
    argument order), cycling its points; gamma per element and 1/w (or W)
    per q-point cycle the fixture's tables."""
    NE, NQ = size
    n = NE * NQ
    J9, dV9, J0i9, e_q, rw, gamma, winv = [a.to(dtype) for a in inputs]
    if layout == "lattice":
        flat = [_cycle(a.reshape(9, -1), n) for a in (J9, dV9, J0i9)]
        pts = [_cycle(a.reshape(-1), n) for a in (e_q, rw, gamma, winv)]
        return flat + pts
    fields = [_cycle(a.reshape(9, -1), n).reshape(9, NE, NQ)
              for a in (J9, dV9, J0i9)]
    pts = [_cycle(a.reshape(-1), n).reshape(NE, NQ) for a in (e_q, rw)]
    if layout == "packed":
        fields = [a.permute(1, 2, 0).reshape(NE, NQ, 3, 3).contiguous()
                  for a in fields]
    return fields + pts + [_cycle(gamma, NE), _cycle(winv, NQ)]


def _padded_launch(layout, args, NQ, kw, pad=1031):
    """Launch the kernel directly into outputs that are views of larger
    buffers holding a sentinel, synchronise, and check that nothing past
    the outputs was written.  Returns (sJit, dtq, visc) views."""
    from laghos_tpu_torch.ops import kernels

    e_q = args[3]
    n, dt, dev = e_q.numel(), e_q.dtype, e_q.device
    bufs = [torch.full((m + pad,), 7.25, dtype=dt, device=dev)
            for m in (9 * n, n, n)]
    shape9 = (9, n) if layout != "packed" else (n, 9)
    sJit, dtq, visc = (bufs[0][:9 * n].view(shape9), bufs[1][:n],
                       bufs[2][:n])
    code = {"element": kernels.ELEMENT, "lattice": kernels.LATTICE,
            "packed": kernels.PACKED}[layout]
    kernels.launch_qphys(code, *args, sJit, dtq, visc, NQ=NQ, **kw)
    torch.cuda.synchronize()
    for b, m in zip(bufs, (9 * n, n, n)):
        assert bool((b[m:] == 7.25).all()), "the kernel wrote out of bounds"
    return sJit, dtq, visc


def _sized_case(layout, inputs, size, dtype, tol, visc, vort, h0):
    """A ragged-size case: kernel (padded launch) against the plain twin."""
    args = _sized(inputs, layout, size, dtype)
    kw = dict(h1order=2.0, cfl=0.5, use_viscosity=visc, use_vorticity=vort)
    launch_kw = dict(h0=h0, **kw)
    NE, NQ = size
    if layout == "lattice":
        s_k, d_k, _ = _padded_launch(layout, args, 1, launch_kw)
        s_p, d_p = qphys.physics_3d_lattice_plain(*args, h0=h0, **kw)
    elif layout == "element":
        s_k, d_k, _ = _padded_launch(layout, args, NQ, launch_kw)
        s_p, d_p = qphys.physics_3d_plain(*args, h0_e=h0, **kw)
        s_p, d_p = s_p.reshape(9, -1), d_p.reshape(-1)
    else:
        s_k, d_k, v_k = _padded_launch(layout, args, NQ, launch_kw)
        s_p, d_p, v_p = qphys.physics_3d_packed_plain(*args, h0=h0, **kw)
        s_p, d_p = s_p.reshape(-1, 9), d_p.reshape(-1)
        _agree_visc(v_k, v_p.reshape(-1), tol)
    _agree(s_k, d_k, s_p, d_p, tol, zero_dt=None)


def _agree_visc(v_k, v_p, tol):
    assert torch.equal(torch.isnan(v_k), torch.isnan(v_p))
    fin = ~torch.isnan(v_p)
    scale = max(float(v_p[fin].abs().max()), 1e-300)
    assert float((v_k[fin] - v_p[fin]).abs().max()) <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("visc,vort", [(True, False), (True, True),
                                       (False, False)])
def test_qphys_kernel_matches_plain(qdata, dtype, tol, visc, vort, size):
    h, inputs = qdata
    if size is not None:
        _sized_case("element", inputs, size, dtype, tol, visc, vort, h.h0)
        return
    args = [a.to(dtype) for a in inputs]
    kw = dict(h0_e=h.h0, h1order=2.0, cfl=0.5, use_viscosity=visc,
              use_vorticity=vort)
    before = qphys.physics_3d.launches
    s_k, d_k = qphys.physics_3d(*args, **kw)
    torch.cuda.synchronize()
    assert qphys.physics_3d.launches == before + 1
    s_p, d_p = qphys.physics_3d_plain(*args, **kw)
    assert torch.equal(torch.isnan(s_k), torch.isnan(s_p))
    assert torch.equal(d_k == 0, d_p == 0)
    assert int((d_p == 0).sum()) == 4
    fin = ~torch.isnan(s_p)
    scale = float(s_p[fin].abs().max())
    assert float((s_k[fin] - s_p[fin]).abs().max()) <= tol * scale
    good = d_p > 0
    dmin = float(d_p[good].min())
    assert abs(float(d_k[good].min()) - dmin) <= tol * dmin


@pytest.mark.cuda
def test_qphys_kernel_refuses_bad_inputs(qdata):
    h, inputs = qdata
    kw = dict(h0_e=h.h0, h1order=2.0, cfl=0.5)
    with pytest.raises(TypeError):
        qphys.physics_3d(*[a.cpu() if i == 4 else a
                           for i, a in enumerate(inputs)], **kw)
    with pytest.raises(ValueError):
        qphys.physics_3d(inputs[0][:, :, ::2], *inputs[1:], **kw)


@pytest.fixture(scope="module")
def lattice_qdata():
    """3D q-lattice data on the card: the default (lattice) Hydro of the
    Sedov mesh refined once, velocity perturbed by a numpy-seeded field,
    with inverted and NaN points."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    m = tmesh.uniform_refine(tmesh.cartesian(3, (2, 2, 2), (1.0, 1.0, 1.0)))
    h = Hydro(m, Options(problem=1), device="cuda")
    assert h._lat is not None
    rng = np.random.default_rng(0)
    S, lat, dims = h.S0, h._lat, h._lat_dims
    v = S["v"] + torch.tensor(0.1 * rng.normal(size=tuple(S["v"].shape)),
                              dtype=h.dtype, device=h.device)
    J9 = torch.stack(tlat.grad9_lattice(S["x"].reshape((3,) + dims),
                                        lat["Ts"], lat["Tg"]))
    dV9 = torch.stack(tlat.grad9_lattice(v.reshape((3,) + dims), lat["Ts"],
                                         lat["Tg"]))
    e_q = tlat.energy_qlattice(S["e"], h._edims, h.tables, 3) + 0.5
    J9[:, 1, 2, 3] *= -1.0             # detJ < 0
    J9[:, 9, 0, 7] *= -1.0
    J9[4, 6, 13, 1] = float("nan")     # NaN geometry
    e_q[2, 7, 4] = float("nan")        # NaN energy
    return h, [J9.contiguous(), dV9.contiguous(), lat["J0i9"],
               e_q.contiguous(), lat["rw"], lat["gam"], lat["winv"]]


def _agree(s_k, d_k, s_p, d_p, tol, zero_dt=4):
    assert torch.equal(torch.isnan(s_k), torch.isnan(s_p))
    assert torch.equal(d_k == 0, d_p == 0)
    if zero_dt is not None:
        assert int((d_p == 0).sum()) == zero_dt
    fin = ~torch.isnan(s_p)
    scale = float(s_p[fin].abs().max())
    assert float((s_k[fin] - s_p[fin]).abs().max()) <= tol * scale
    good = d_p > 0
    if bool(good.any()):
        dmin = float(d_p[good].min())
        assert abs(float(d_k[good].min()) - dmin) <= tol * dmin


@pytest.mark.cuda
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("visc,vort", [(True, False), (True, True),
                                       (False, False)])
def test_qphys_lattice_kernel_matches_plain(lattice_qdata, dtype, tol, visc,
                                            vort, size):
    h, inputs = lattice_qdata
    if size is not None:
        _sized_case("lattice", inputs, size, dtype, tol, visc, vort, h.h0)
        return
    args = [a.to(dtype) for a in inputs]
    kw = dict(h0=h.h0, h1order=2.0, cfl=0.5, use_viscosity=visc,
              use_vorticity=vort)
    before = qphys.physics_3d_lattice.launches
    s_k, d_k = qphys.physics_3d_lattice(*args, **kw)
    torch.cuda.synchronize()
    assert qphys.physics_3d_lattice.launches == before + 1
    s_p, d_p = qphys.physics_3d_lattice_plain(*args, **kw)
    _agree(s_k, d_k, s_p, d_p, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("visc,vort", [(True, False), (True, True),
                                       (False, False)])
@pytest.mark.parametrize("size", SIZES)
def test_qphys_packed_kernel_matches_plain(qdata, dtype, tol, visc, vort,
                                           size):
    h, inputs = qdata
    if size is not None:
        packed_inputs = inputs[:6] + [h.tables["W"]]
        _sized_case("packed", packed_inputs, size, dtype, tol, visc, vort,
                    h.h0)
        return
    J9, dV9, J0i9, e_q, rw, gamma, winv = [a.to(dtype) for a in inputs]
    NE, NQ = e_q.shape

    def packed(A9):
        return A9.permute(1, 2, 0).reshape(NE, NQ, 3, 3).contiguous()

    W = h.tables["W"].to(dtype)
    kw = dict(h0=h.h0, h1order=2.0, cfl=0.5, use_viscosity=visc,
              use_vorticity=vort)
    args = [packed(J9), packed(dV9), packed(J0i9), e_q, rw, gamma, W]
    before = qphys.physics_3d_packed.launches
    s_k, d_k, v_k = qphys.physics_3d_packed(*args, **kw)
    torch.cuda.synchronize()
    assert qphys.physics_3d_packed.launches == before + 1
    s_p, d_p, v_p = qphys.physics_3d_packed_plain(*args, **kw)
    _agree(s_k, d_k, s_p, d_p, tol)
    _agree_visc(v_k, v_p, tol)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _split_operand(seed=0):
    """(3, 17, 33) f64 with mixed magnitudes, an all-zero row, a NaN row
    and an Inf row along axis 1."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((3, 17, 33)) * np.exp2(
        rng.integers(-30, 30, (3, 17, 33)))
    A[1, :, 5] = 0.0
    A[2, 4, 7] = np.nan
    A[0, 9, 30] = np.inf
    return torch.tensor(A)


def _split_edges(R1, k, R2, seed=0):
    """(R1, k, R2) f64 of mixed magnitudes whose rows along axis 1 include,
    as far as there are rows: all zeros, subnormals, -0.0, values near
    2^1000 and near 2^-1000, a NaN and an Inf."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((R1, k, R2)) * np.exp2(
        rng.integers(-30, 30, (R1, k, R2)))
    M = R1 * R2
    special = [
        lambda r: np.zeros(k),
        lambda r: r * 2.0 ** -1060,                # subnormal
        lambda r: np.full(k, -0.0),
        lambda r: r * 2.0 ** 1000,
        lambda r: r * 2.0 ** -1000,
        lambda r: np.where(np.arange(k) == k // 2, np.nan, r),
        lambda r: np.where(np.arange(k) == 0, np.inf, r),
    ]
    rows = np.linspace(0, M - 1, len(special)).astype(int)
    for f, row in zip(special, rows):
        r1, r2 = divmod(int(row), R2)
        A[r1, :, r2] = f(rng.standard_normal(k))
    return torch.tensor(A)


# (operand, axis): the mixed (3, 17, 33) operand over each axis, then
# (R1, k, R2) edge operands split over axis 1 (the tiling's edges: k below,
# at and above a multiple of 8, the longest row a tile takes whole (512)
# and the next, in two chunks, and k = 1,536 in three; R2 = 1, the flat
# loads, and R2 around a tile of 32 rows and the H1 lattice's 65^2)
SPLIT_CASES = [("mixed", a) for a in (0, 1, 2)] + [
    ((R1, k, R2), 1) for R1 in (1, 3)
    for k in (1, 7, 8, 9, 65, 128, 129, 512, 513, 1536)
    for R2 in (1, 31, 32, 33, 4225)]


@pytest.mark.cuda
@pytest.mark.parametrize("operand,axis", SPLIT_CASES,
                         ids=[f"{o}-{a}" for o, a in SPLIT_CASES])
@pytest.mark.parametrize("S", [8, 6, 4, 1])
def test_split_kernel_matches_plain_bitwise(operand, axis, S):
    dev = _card()
    mixed = operand == "mixed"
    A = (_split_operand() if mixed else _split_edges(*operand)).to(dev)
    before = omm.split_dyn.launches
    k = omm.split_dyn(A, S, axis)
    torch.cuda.synchronize()
    assert omm.split_dyn.launches == before + 1
    p = omm.split_dyn_plain(A, S, axis)
    assert torch.equal(k.cat, p.cat)
    assert torch.equal(k.scale.view(torch.int64), p.scale.view(torch.int64))
    if mixed:
        assert int(torch.isnan(k.scale).sum()) > 0
        c = omm.split_dyn_plain(A.cpu(), S, axis)
        assert torch.equal(k.cat.cpu(), c.cat)
    elif operand[0] * operand[2] >= 7:
        assert int(torch.isnan(k.scale).sum()) == 2


@pytest.mark.cuda
def test_split_dyn_never_falls_back_on_card(monkeypatch):
    dev = _card()

    def refuse(*a, **k):
        raise AssertionError("the plain twin ran for a CUDA tensor")

    monkeypatch.setattr(omm, "split_dyn_plain", refuse)
    A = torch.randn(40, 65, dtype=torch.float64, device=dev)
    before = omm.split_dyn.launches
    omm.split_dyn(A, 8)
    torch.cuda.synchronize()
    assert omm.split_dyn.launches == before + 1
    with pytest.raises(TypeError):
        omm.split_dyn(A.float())
    with pytest.raises(ValueError):
        omm.split_dyn(A.t())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,axis,n,S", [
    ((3, 17, 29), 1, 12, 8), ((2, 65, 9), 1, 65, 8), ((5, 65), 1, 128, 8),
    ((4, 3, 64), 2, 8, 6), ((7, 8, 6), 0, 27, 4)])
def test_int8_products_on_card_match_cpu(shape, axis, n, S):
    """The padded cuBLASLt int8 product and the reconstruction on the card
    give the CPU's bits (exact int32 sums, the same elementwise ops)."""
    dev = _card()
    rng = np.random.default_rng(11)
    A = torch.tensor(rng.standard_normal(shape))
    B = rng.standard_normal((shape[axis], n))
    y_cpu = omm.tensordot(A, omm.split_static(B), axis, S)
    y_gpu = omm.tensordot(A.to(dev), omm.split_static(B, device=dev), axis,
                          S)
    assert torch.equal(y_gpu.cpu(), y_cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, dict(structured_el=False,
                                         lattice_ops=False,
                                         precond="jacobi")])
def test_ozaki_mult_on_card_matches_cpu(kw):
    dev = _card()
    m = tmesh.uniform_refine(tmesh.cartesian(3, (2, 2, 2), (1.0, 1.0, 1.0)))
    opt = dict(problem=1, blast_energy=2.0, cg_tol=1e-12, ozaki=True, **kw)
    hc = Hydro(m, Options(**opt), device="cpu")
    hg = Hydro(m, Options(**opt), device=dev)
    before = omm.split_dyn.launches
    a, dta, _ = hc._mult(hc.S0)
    b, dtb, _ = hg._mult(hg.S0)
    torch.cuda.synchronize()
    assert omm.split_dyn.launches > before
    for key in ("x", "v", "e"):
        ref = a[key]
        err = float((b[key].cpu() - ref).abs().max())
        assert err <= 1e-12 * max(float(ref.abs().max()), 1e-300), key
    assert abs(float(dtb) - float(dta)) <= 1e-12 * float(dta)


def _fa_mass(dim, rs, seed=0):
    """The assembled scalar H1 mass (Q2) of the Sedov mesh refined rs
    times, with seeded quadrature data, as element matrices and gather."""
    from laghos_tpu_torch.fem import basis as tbasis
    from laghos_tpu_torch.fem import space as tspace
    from laghos_tpu_torch.ops import assemble as tasm

    m = tmesh.cartesian(dim, (2,) * dim, (1.0,) * dim)
    for _ in range(rs):
        m = tmesh.uniform_refine(m)
    sp = tspace.build_h1_space(m, 2)
    B = torch.tensor(tbasis.h1_gl_basis(2, 4).B)
    rng = np.random.default_rng(seed)
    D = torch.tensor(rng.uniform(0.5, 1.5, (m.num_elems, 4**dim)))
    return tasm.h1_mass_element_matrices(D, B, dim).numpy(), sp, rng


@pytest.mark.cuda
@pytest.mark.parametrize("dim,rs", [(1, 5), (2, 3), (3, 2)])
def test_csr_apply_on_card_matches_cpu_and_repeats(dim, rs):
    """The FA velocity mass product (ops/assemble.csr_apply) on the card
    against the CPU at round-off, and bit for bit equal to itself over
    repeated applies and a second copy of the matrix."""
    from laghos_tpu_torch.ops import assemble as tasm

    dev = _card()
    Mel, sp, rng = _fa_mass(dim, rs)
    A_cpu = tasm.to_csr(Mel, sp.gather, sp.ndof)
    A_gpu = tasm.to_csr(Mel, sp.gather, sp.ndof, dev)
    assert torch.equal(A_gpu.values().cpu(), A_cpu.values())
    u = torch.tensor(rng.normal(size=(dim, sp.ndof)))
    y_cpu = tasm.csr_apply(A_cpu, u)
    y = tasm.csr_apply(A_gpu, u.to(dev))
    torch.cuda.synchronize()
    assert float((y.cpu() - y_cpu).abs().max()) <= \
        1e-14 * float(y_cpu.abs().max())
    for _ in range(50):
        assert torch.equal(tasm.csr_apply(A_gpu, u.to(dev)), y)
    A2 = tasm.to_csr(Mel, sp.gather, sp.ndof, dev)
    assert torch.equal(tasm.csr_apply(A2, u.to(dev)), y)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, dict(structured_el=False,
                                         lattice_ops=False)])
def test_schwarz_apply_on_card_matches_cpu_and_repeats(kw):
    """The element-block Schwarz preconditioner on the lattice path (the
    parity transforms) and the gather path (the incidence gather): on the
    card against the CPU at round-off, and bit for bit equal to itself
    over repeated applies."""
    dev = _card()
    m = tmesh.uniform_refine(tmesh.cartesian(3, (2, 2, 2), (1.0, 1.0, 1.0)))
    opt = Options(problem=1, precond="schwarz", **kw)
    hc, hg = Hydro(m, opt, device="cpu"), Hydro(m, opt, device=dev)
    r = torch.tensor(np.random.default_rng(2).normal(size=(3, hc.ndof)))
    y_cpu = hc._precond_velocity(r)
    y = hg._precond_velocity(r.to(dev))
    torch.cuda.synchronize()
    assert float((y.cpu() - y_cpu).abs().max()) <= \
        1e-13 * float(y_cpu.abs().max())
    for _ in range(20):
        assert torch.equal(hg._precond_velocity(r.to(dev)), y)


@pytest.mark.cuda
def test_simplex_assembly_on_card_repeats():
    """The simplex path's assembly (the incidence gather of ops/mass.py
    that replaces the JAX package's scatter-add): the tet mass apply on
    the card against the CPU at round-off and bit for bit equal to itself
    over 50 applies."""
    from laghos_tpu_torch.fem import simplex_mesh as tsm
    from laghos_tpu_torch.simplex_hydro import SimplexHydro

    dev = _card()
    m = tsm.uniform_refine_tet(tsm.make_tet_mesh((2, 2, 2)))
    opt = Options(problem=1, ode_solver=7)
    hc, hg = SimplexHydro(m, opt, device="cpu"), SimplexHydro(m, opt,
                                                              device=dev)
    u = torch.tensor(np.random.default_rng(3).normal(size=(3, hc.ndof)))
    y_cpu = hc._mass_apply(u)
    y = hg._mass_apply(u.to(dev))
    torch.cuda.synchronize()
    assert float((y.cpu() - y_cpu).abs().max()) <= \
        1e-13 * float(y_cpu.abs().max())
    for _ in range(50):
        assert torch.equal(hg._mass_apply(u.to(dev)), y)
    S, _, steps = hg.run(0.6, max_steps=2)
    assert steps == 3 and bool(torch.isfinite(S["e"]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [2, 3])
def test_amr_gathers_on_card_repeat(dim):
    """The AMR operator's P and P^T gather tables and its constrained mass
    apply (the incidence assembly, where the JAX package scatter-adds) on
    a graded, non-2:1 forest: on the card against the CPU at round-off, and
    bit for bit equal to themselves over 50 applies."""
    from laghos_tpu_torch.amr.forest import Forest
    from laghos_tpu_torch.amr.solver import AMRHydro

    dev = _card()

    def forest():
        f = Forest(dim, (2,) * dim, (1.0,) * dim, max_depth=3)
        for _ in range(3):
            f.refine([k for k in f.leaf_list() if not any(k[1])],
                     balance=False)
        return f

    opt = Options(problem=1, blast_energy=0.25, order_v=2, order_e=1)
    hc = AMRHydro(forest(), opt, h0=0.25, device="cpu")
    hg = AMRHydro(forest(), opt, h0=0.25, device=dev)
    rng = np.random.default_rng(5)
    uT = torch.tensor(rng.normal(size=(dim, hc.nt)))
    yL = torch.tensor(rng.normal(size=(dim, hc.nn)))
    ops = [("P", hc._p_apply, hg._p_apply, uT),
           ("P^T", hc._pT_apply, hg._pT_apply, yL),
           ("mass", hc.mass_apply, hg.mass_apply, uT)]
    for name, fc, fg, u in ops:
        y_cpu = fc(u)
        y = fg(u.to(dev))
        torch.cuda.synchronize()
        assert float((y.cpu() - y_cpu).abs().max()) <= \
            1e-13 * float(y_cpu.abs().max()), name
        for _ in range(50):
            assert torch.equal(fg(u.to(dev)), y), name


@pytest.mark.cuda
def test_graphed_cg_matches_eager():
    """The CG's iterations replayed from a CUDA graph (`cg(graph=True)`,
    the AMR velocity solve) give the eager solve's bits and iteration
    count, on the constrained mass of a graded 3D forest at its
    300-iteration cap and at a converging tolerance.  The eager solve is
    the eager iteration's (a dot passed in: without one, a solve without
    a graph runs csrc/cg.cu's chain)."""
    from laghos_tpu_torch.amr.forest import Forest
    from laghos_tpu_torch.amr.solver import AMRHydro
    from laghos_tpu_torch.solvers.cg import sum_dot, cg

    dev = _card()
    f = Forest(3, (2, 2, 2), (1.0,) * 3, max_depth=2)
    for _ in range(2):
        f.refine([k for k in f.leaf_list() if not any(k[1])],
                 balance=False)
    h = AMRHydro(f, Options(problem=1, blast_energy=0.25), h0=0.25,
                 device=dev)
    b = torch.tensor(np.random.default_rng(9).normal(size=(1, 3 * h.nt)),
                     device=dev)
    b = h.mass_apply(b.reshape(3, -1)).reshape(1, -1)

    def apply(u):
        return h.mass_apply(u.reshape(3, -1)).reshape(1, -1)

    for tol, reads in ((1e-8, None), (1e-13, [None]), (1e-13, [40])):
        res = [cg(apply, b, tol, 300, reads=None if reads is None
                  else list(reads), graph=g, dot=None if g else sum_dot)
               for g in (False, True)]
        assert torch.equal(res[0].x, res[1].x), tol
        assert torch.equal(res[0].iters, res[1].iters), tol


def _cg_hydro(dev, order_v, order_e, rs):
    """The 3D Sedov Hydro of a benchmark cell's orders at `rs`, Jacobi."""
    m = tmesh.cartesian(3, (2, 2, 2), (1.0, 1.0, 1.0))
    for _ in range(rs):
        m = tmesh.uniform_refine(m)
    return Hydro(m, Options(problem=1, order_v=order_v, order_e=order_e,
                            precond="jacobi"), device=dev)


def _cg_systems(h, seed=0):
    """The velocity and energy CG systems of `h` as `Hydro._cg_velocity`
    and `_cg_energy` pass them to `cg`, on seeded right-hand sides."""
    rng = np.random.default_rng(seed)
    vb = torch.tensor(rng.normal(size=(h.dim, h.ndof)), dtype=h.dtype,
                      device=h.device)
    vb = torch.where(h.ess_mask_t, torch.zeros_like(vb), vb)
    eb = torch.tensor(rng.normal(size=(1, h.NE * h.ld)), dtype=h.dtype,
                      device=h.device)

    def apply_l2(u):
        ue = tmass.mass_apply_e(u.reshape(h.NE, h.ld), h.massD,
                                h.tables["L2B"], h.dim)
        return ue.reshape(1, -1)

    return {"h1": (h._h1_apply, vb, dict(precond_diag=h.h1_dinv,
                                         ess=h.ess_mask_t)),
            "l2": (apply_l2, eb, {})}


@pytest.mark.cuda
@pytest.mark.parametrize("rs", [0, 1, 2])
@pytest.mark.parametrize("orders", [(2, 1), (4, 3)], ids=["q2q1", "q4q3"])
def test_fused_cg_matches_generic(orders, rs):
    """The fused chain (csrc/cg.cu) against the eager iteration on both
    benchmark cells' velocity and energy systems, counts equal or within
    one (the dots are summed in another order): at CG tolerance 1e-14, x
    to 1e-12 of its size, a warm start too; at the cells' 1e-11 a row may
    stop one iteration apart, and that step moves x by about the
    tolerance (3.4e-12 at Q2-Q1 rs1, where the eager iteration on the CPU
    and on the card part by 1.1e-12 at rs0), so x to 1e-10 there.  Two
    fused solves bit for bit; the fused solve with the `reads` schedule
    bit for bit the one reading the flag every iteration; each solve
    counted on its path while tracing."""
    from laghos_tpu_torch import timing
    from laghos_tpu_torch.solvers import cg as cgm

    h = _cg_hydro(_card(), *orders, rs)
    for site, (apply, b, kw) in _cg_systems(h).items():
        for tol, xtol in ((1e-14, 1e-12), (1e-11, 1e-10)):
            steps = cgm.chain_step.launches
            with timing.trace() as tr:
                fused = cgm.cg(apply, b, tol, 300, **kw)
                # a dot passed in takes the eager iteration (the same sum
                # as the one-device dot)
                generic = cgm.cg(apply, b, tol, 300, dot=cgm.sum_dot, **kw)
            n_f, n_g = int(fused.iters.max()), int(generic.iters.max())
            assert tr.cg_iters == {("", "fused"): n_f, ("", "generic"): n_g}
            assert cgm.chain_step.launches - steps == n_f
            assert bool(fused.converged.all()) and n_f < 300, site
            assert (fused.iters - generic.iters).abs().max() <= 1, site
            scale = float(generic.x.abs().max())
            err = float((fused.x - generic.x).abs().max())
            assert err <= xtol * scale, (site, tol, err / scale)
        again = cgm.cg(apply, b, tol, 300, **kw)
        assert torch.equal(again.x, fused.x), site
        assert torch.equal(again.iters, fused.iters), site
        for prev in (None, n_f, n_f + 5, 3):
            reads = [prev]
            few = cgm.cg(apply, b, tol, 300, reads=reads, **kw)
            assert torch.equal(few.x, fused.x), (site, prev)
            assert torch.equal(few.iters, fused.iters), (site, prev)
            assert reads[0] <= n_f + 1, (site, prev)
        x0 = 0.5 * fused.x
        warm = [cgm.cg(apply, b, 1e-14, 300, x0=x0, dot=dot, **kw)
                for dot in (None, cgm.sum_dot)]
        assert torch.equal(x0, 0.5 * fused.x), site
        err = float((warm[0].x - warm[1].x).abs().max())
        assert err <= 1e-12 * scale, (site, err / scale)
        assert (warm[0].iters - warm[1].iters).abs().max() <= 1, site


@pytest.mark.cuda
@pytest.mark.parametrize("orders,rs", cg_reference.CASES,
                         ids=[f"q{o[0]}q{o[1]}-rs{r}"
                              for o, r in cg_reference.CASES])
def test_fused_cg_matches_jax(orders, rs):
    """Hydro's velocity and energy solves on the card, through the fused
    chain (csrc/cg.cu), against the JAX package's solves of the same
    systems (tests/data/cg_jax_reference.npz, which
    tests/test_torch_ops.py::test_cg_reference_is_jax holds to
    `laghos_tpu.solvers.cg` on the CPU): at CG tolerance 1e-14 counts
    within one (the dots are summed in another order), x to 1e-12.  The
    velocity solve takes the arguments `Hydro._cg_velocity` passes to
    `cg`, the energy solve is `Hydro._cg_energy` itself; every iteration
    of both runs on the chain."""
    from laghos_tpu_torch import timing
    from laghos_tpu_torch.solvers import cg as cgm

    dev = _card()
    ref = cg_reference.load()
    m = tmesh.cartesian(3, (2, 2, 2), (1.0, 1.0, 1.0))
    for _ in range(rs):
        m = tmesh.uniform_refine(m)
    h = Hydro(m, Options(**cg_reference.options(orders)), device=dev)
    M, dinv = h._velocity_precond()
    assert M is None and h._cg_dot_h1 is None and h._cg_dot_l2 is None
    b = torch.tensor(cg_reference.velocity_rhs(h.ess_mask), dtype=h.dtype,
                     device=dev)
    e = torch.tensor(cg_reference.rhs((h.NE, h.ld), 0.75), dtype=h.dtype,
                     device=dev)
    with timing.trace() as tr:
        res = cgm.cg(h._h1_apply, b, h.opt.cg_tol, h.opt.cg_max_iter,
                     precond_diag=dinv, ess=h.ess_mask_t, dot=h._cg_dot_h1)
        ex, eit = h._cg_energy(e)
    assert {path for _, path in tr.cg_iters} == {"fused"}, tr.cg_iters
    assert bool(res.converged.all())
    for name, x, it in (("v", res.x, res.iters), ("e", ex, eit)):
        want_x = ref[cg_reference.key(orders, rs, f"{name}_x")]
        want_it = ref[cg_reference.key(orders, rs, f"{name}_iters")]
        got_it = it.cpu().numpy()
        assert np.abs(got_it - want_it).max() <= 1, (name, got_it, want_it)
        x = x.cpu().numpy()
        err = np.abs(x - want_x).max() / np.abs(want_x).max()
        assert err <= 1e-12, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_cg_edges(dtype):
    """The chain on small systems at ragged sizes (1 row and 5 rows, n
    from 1 to 3 blocks and a bit), rows converging apart, a row broken
    down at once (negative definite) and the max_iter cap: the eager
    iteration's counts (f32: within one), x as close as the dots' order
    allows, and the caller's b untouched."""
    from laghos_tpu_torch.solvers import cg as cgm

    dev = _card()
    # CG tolerance, x agreement, count slack: an f32 dot summed in another
    # order may move a stop by one iteration
    cg_tol, tol, slack = {torch.float64: (1e-8, 1e-10, 0),
                          torch.float32: (1e-4, 1e-3, 1)}[dtype]
    rng = np.random.default_rng(11)
    for C, n in ((1, 1), (1, 257), (5, 700), (2, 5000)):
        eig = np.geomspace(1.0, 50.0, n)
        diag = torch.tensor(np.stack([rng.permutation(eig) * (1 + c)
                                      for c in range(C)]), dtype=dtype,
                            device=dev)
        if C > 1:
            diag[1] = -diag[1]           # den < 0 at the first iteration
        b = torch.tensor(rng.normal(size=(C, n)), dtype=dtype, device=dev)
        b0 = b.clone()
        dinv = 1.0 / diag.abs().sqrt()

        def apply(u):
            return diag * u

        for max_iter in (300, 3):
            res = [cgm.cg(apply, b, cg_tol, max_iter, precond_diag=dinv,
                          dot=dot) for dot in (None, cgm.sum_dot)]
            assert torch.equal(b, b0)
            assert (res[0].iters - res[1].iters).abs().max() <= slack, (
                C, n, max_iter)
            scale = float(res[1].x.abs().max())
            assert float((res[0].x - res[1].x).abs().max()) <= tol * scale
            if C > 1:
                assert int(res[0].iters[1]) == 1
                assert not bool(res[0].x[1].any())


@pytest.mark.cuda
def test_fused_cg_on_hydro_pa_path():
    """Every CG iteration of Hydro's PA Jacobi path runs on the fused chain
    while tracing (`Tracer.cg_iters`), the velocity and the energy solves
    alike."""
    from laghos_tpu_torch import driver, timing

    h = _cg_hydro(_card(), 2, 1, 1)
    driver.run(h, t_final=0.6, max_steps=3, vis_steps=10**6, timing=True)
    counts = timing.last_trace().cg_iters
    assert {k for k, n in counts.items() if n} == {
        ("laghos.cg_h1", "fused"), ("laghos.cg_l2", "fused")}, counts


# (nd1, nq1) of csrc/mass.cu's compiled instances (2D and 3D), then sizes of
# its runtime-size kernel: every 1D size, and 2D/3D sizes of no compiled
# instance (an odd nq1, nd1 > nq1, -ok 5's L2, -ok 12's H1, the largest
# that fits in f64)
MASS_COMPILED = [(1, 2), (2, 2), (2, 4), (3, 4), (3, 6), (4, 6), (4, 8),
                 (5, 8), (6, 12), (7, 12), (8, 16), (9, 16)]
MASS_CASES = ([(dim, d1, q1) for dim in (2, 3) for d1, q1 in MASS_COMPILED]
              + [(1, 3, 4), (1, 9, 16), (1, 20, 40), (2, 3, 5), (2, 5, 3),
                 (3, 5, 10), (3, 2, 3), (3, 13, 24)])


def _mass_operands(dim, d1, q1, C, NE, dtype, dev, seed=0):
    """Seeded u (C, NE, d1^dim), positive D (NE, q1^dim) and a table B
    (q1, d1) on `dev`."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(a, dtype=dtype, device=dev)

    return (t(rng.standard_normal((C, NE, d1**dim))),
            t(rng.uniform(0.5, 1.5, (NE, q1**dim))),
            t(rng.standard_normal((q1, d1))))


# NE of each case, for elements groups of `epb` (a block's group) and a
# compiled instance's grid of `grid` blocks, each walking groups until none
# is left: two groups and a ragged one; one element; fewer groups than
# blocks; three groups a block and a ragged remainder; Q8-Q7's NE
MASS_NE = {"ragged": lambda epb, grid: 2 * epb + 3,
           "one": lambda epb, grid: 1,
           "below": lambda epb, grid: (grid // 2) * epb + 1,
           "walk": lambda epb, grid: 3 * grid * epb + epb // 2 + 1,
           "q8": lambda epb, grid: 4096}
MASS_NE_CASES = [(dim, d1, q1, ne) for dim, d1, q1 in MASS_CASES
                 for ne in (("ragged", "one", "below", "walk")
                            if (d1, q1) in MASS_COMPILED and dim > 1
                            else ("ragged", "one"))
                 + (("q8",) if (dim, d1, q1) == (3, 8, 16) else ())]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("dim,d1,q1,ne", MASS_NE_CASES,
                         ids=[f"{d}d-{a}-{b}-{n}"
                              for d, a, b, n in MASS_NE_CASES])
def test_mass_kernel_matches_plain(dim, d1, q1, ne, C, dtype, tol):
    """The kernel against its plain twin at every compiled size and at
    runtime sizes, relative to max|twin|, on NE values that leave a ragged
    last group, and for the compiled instances (persistent blocks that
    copy the next group in while the current one runs) on one element,
    on fewer groups than blocks and on several groups a block; a second
    launch gives the same bits."""
    from laghos_tpu_torch.ops import kernels

    dev = _card()
    epb = max(1, 2048 // q1**dim)
    grid = kernels.mass_grid(dtype, dev.index or 0, dim=dim, nd1=d1, nq1=q1)
    assert (grid > 0) == ((d1, q1) in MASS_COMPILED and dim > 1)
    NE = MASS_NE[ne](epb, grid)
    u, D, B = _mass_operands(dim, d1, q1, C, NE, dtype, dev)
    before = tmass.mass_apply_e.launches
    y = tmass.mass_apply_e(u, D, B, dim)
    torch.cuda.synchronize()
    assert tmass.mass_apply_e.launches == before + 1
    p = tmass.mass_apply_e_plain(u, D, B, dim)
    assert y.dtype == dtype and y.shape == u.shape
    err = float((y - p).abs().max())
    assert err <= tol * float(p.abs().max()), err
    assert torch.equal(tmass.mass_apply_e(u, D, B, dim), y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("dim,d1,q1", [(2, 3, 4), (3, 2, 4), (3, 8, 16),
                                       (3, 9, 16)])
def test_mass_runtime_kernel_at_compiled_sizes(dim, d1, q1, dtype, tol):
    """The runtime-size kernel forced at compiled sizes (as chip_smoke.py
    times the two) against the twin, C = dim, uncounted by the wrapper."""
    from laghos_tpu_torch.ops import kernels

    dev = _card()
    NE = 2 * max(1, 2048 // q1**dim) + 3
    u, D, B = _mass_operands(dim, d1, q1, dim, NE, dtype, dev, seed=3)
    before = tmass.mass_apply_e.launches
    y = torch.empty_like(u)
    kernels.launch_mass(u, D, B, y, C=dim, NE=NE, dim=dim, nd1=d1, nq1=q1,
                        rt=True)
    torch.cuda.synchronize()
    assert tmass.mass_apply_e.launches == before
    p = tmass.mass_apply_e_plain(u, D, B, dim)
    assert float((y - p).abs().max()) <= tol * float(p.abs().max())


@pytest.mark.cuda
def test_mass_kernel_takes_views_and_never_falls_back(monkeypatch):
    """A strided (3, NE, nd) view (the gather path's E-vector) and a
    leading-free (NE, nd) operand (the energy CG's) go to the kernel, never
    to the twin; other dtypes and sizes beyond the shared memory a block
    may have raise."""
    dev = _card()
    u, D, B = _mass_operands(3, 3, 4, 3, 40, torch.float64, dev, seed=2)
    ref = tmass.mass_apply_e_plain(u, D, B, 3)

    def refuse(*a, **k):
        raise AssertionError("the plain twin ran for a CUDA tensor")

    monkeypatch.setattr(tmass, "mass_apply_e_plain", refuse)
    view = u.transpose(0, 1).contiguous().transpose(0, 1)
    assert not view.is_contiguous()
    before = tmass.mass_apply_e.launches
    y = tmass.mass_apply_e(view, D, B, 3)
    y0 = tmass.mass_apply_e(u[0], D, B, 3)
    torch.cuda.synchronize()
    assert tmass.mass_apply_e.launches == before + 2
    assert float((y - ref).abs().max()) <= 1e-13 * float(ref.abs().max())
    assert torch.equal(y0, y[0])
    with pytest.raises(TypeError):
        tmass.mass_apply_e(u.half(), D.half(), B.half(), 3)
    big = _mass_operands(3, 14, 26, 1, 2, torch.float64, dev)
    with pytest.raises(RuntimeError, match="shared memory"):
        tmass.mass_apply_e(*big, 3)
    assert tmass.mass_apply_e.launches == before + 2


@pytest.mark.cuda
def test_mass_kernel_on_hydro_tables_matches_dense():
    """At the flagship's L2 and H1 tables (Q2-Q1) the kernel agrees with
    the dense element mass matrices of `l2_mass_matrices` (one batched
    product), and repeats bit for bit."""
    dev = _card()
    m = tmesh.uniform_refine(tmesh.cartesian(3, (2, 2, 2), (1.0, 1.0, 1.0)))
    h = Hydro(m, Options(problem=1, structured_el=False, lattice_ops=False,
                         precond="jacobi"), device=dev)
    rng = np.random.default_rng(5)
    for name, C in (("L2B", 1), ("H1B", 3)):
        B = h.tables[name]
        u = torch.tensor(rng.standard_normal((C, h.NE, B.shape[1] ** 3)),
                         dtype=h.dtype, device=dev)
        y = tmass.mass_apply_e(u, h.massD, B, 3)
        M = tmass.l2_mass_matrices(h.massD, B, 3)
        dense = torch.einsum("eij,cej->cei", M, u)
        assert float((y - dense).abs().max()) <= 1e-13 * float(
            dense.abs().max()), name
        assert torch.equal(tmass.mass_apply_e(u, h.massD, B, 3), y), name


# the lattice mass kernel (csrc/lattice_mass.cu): H1 orders of its compiled
# instances, on one element, on ragged non-cubic grids (2D 7 x 3, 3D 5 x 3
# x 2), on a grid of several element groups a persistent block (Q2-Q1 at
# 24 x 20 x 20) and the q8 grid (Q8-Q7 at 16^3); orders of the runtime-size
# body (5, 7) and 1D.  Grids at the seams of a brick-wise design (a tile
# of the (y, z) cross-section stepped along x; dims (n_x, n_y[, n_z])):
# one 4 x 4 or 8 x 8 tile (Q2-Q1 1 x 4 x 4, Q1 1 x 8 x 8, 2D Q2-Q1 1 x
# 16), element counts off such tiles along y and z (Q2-Q1 7 x 6 x 5, Q1 3
# x 9 x 11, Q3-Q2 3 x 3 x 5, Q4-Q3 2 x 3 x 5, Q8-Q7 5 x 2 x 3, 2D Q4-Q3 3
# x 9, Q6-Q5 5 x 5, Q8-Q7 4 x 3), a long x walk (Q2-Q1 33 x 4 x 4), and
# the lattices of rank 1 of 2 slabs (8 x 4 x 2) and of rank 3 of 2 x 2
# pencils (8 x 2 x 2) of the box at rs1
LAT_COMPILED = (1, 2, 3, 4, 6, 8)
LAT_CASES = ([(o, (1,) * d) for d in (2, 3) for o in LAT_COMPILED]
             + [(o, dims) for dims in ((7, 3), (5, 3, 2))
                for o in LAT_COMPILED]
             + [(2, (24, 20, 20)), (8, (16, 16, 16)), (5, (3, 2, 2)),
                (7, (2, 3)), (2, (6,)), (8, (4,))]
             + [(2, (1, 4, 4)), (1, (1, 8, 8)), (2, (1, 16)), (2, (7, 6, 5)),
                (1, (3, 9, 11)), (3, (3, 3, 5)), (4, (2, 3, 5)),
                (8, (5, 2, 3)), (4, (3, 9)), (6, (5, 5)), (8, (4, 3)),
                (2, (33, 4, 4)), (2, (8, 4, 2)), (2, (8, 2, 2))])


def _lattice_operands(order, dims, C, dtype, dev, seed=0):
    """Seeded u (C, prod L), the banded tables (z, y, x) of the H1 table of
    `order`, positive q-lattice weights and the lattice dims, on `dev`, for
    the raster lattice of element dims (n_x, n_y[, n_z])."""
    from laghos_tpu_torch.fem import basis, quadrature

    nq1 = quadrature.points_for_order(
        quadrature.default_rule_order(order, order - 1))
    B = np.asarray(basis.h1_gl_basis(order, nq1).B)
    n_zyx = tuple(reversed(dims))
    lat = tuple(n * order + 1 for n in n_zyx)
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(a, dtype=dtype, device=dev)

    return (t(rng.standard_normal((C, int(np.prod(lat))))),
            [t(tlat.banded_eval_table(B, n)) for n in n_zyx],
            t(rng.uniform(0.5, 1.5, tuple(n * nq1 for n in n_zyx))), lat)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("C", ["dim", 1])
@pytest.mark.parametrize("order,dims", LAT_CASES,
                         ids=[f"p{o}-{'x'.join(map(str, d))}"
                              for o, d in LAT_CASES])
def test_lattice_mass_kernel_matches_plain(order, dims, C, dtype, tol):
    """The lattice kernel against its plain twin (the banded tensordot
    chain), relative to max|twin|, counted once a call; a second launch
    gives the same bits."""
    dev = _card()
    C = len(dims) if C == "dim" else C
    u, Ts, Dq, lat = _lattice_operands(order, dims, C, dtype, dev)
    before = tlat.mass_apply_lattice.launches
    y = tlat.mass_apply_lattice(u, Ts, Dq, lat)
    torch.cuda.synchronize()
    assert tlat.mass_apply_lattice.launches == before + 1
    p = tlat.mass_apply_lattice_plain(u, Ts, Dq, lat)
    assert y.dtype == dtype and y.shape == u.shape
    err = float((y - p).abs().max())
    assert err <= tol * float(p.abs().max()), err
    assert torch.equal(tlat.mass_apply_lattice(u, Ts, Dq, lat), y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("order,dims", [(2, (5, 3, 2)), (8, (2, 2, 3)),
                                        (4, (7, 3)), (2, (1, 4, 4)),
                                        (2, (7, 6, 5)), (2, (8, 2, 2)),
                                        (1, (1, 16))])
def test_lattice_mass_runtime_body_at_compiled_sizes(order, dims, dtype, tol):
    """The runtime-size body forced at compiled sizes (as chip_smoke.py
    times the two) against the twin, uncounted by the wrapper."""
    from laghos_tpu_torch.ops import kernels

    dev = _card()
    u, Ts, Dq, lat = _lattice_operands(order, dims, len(dims), dtype, dev, 4)
    tab = tlat.lattice_table(Ts)
    before = tlat.mass_apply_lattice.launches
    y = torch.empty_like(u)
    ye = torch.empty((u.shape[0], int(np.prod(dims)), tab.nd1 ** len(dims)),
                     dtype=dtype, device=dev)
    kernels.launch_lattice_mass(u, Dq, tab.B, tab.host, ye, y, C=u.shape[0],
                                elems=tab.elems, nd1=tab.nd1, nq1=tab.nq1,
                                rt=True)
    torch.cuda.synchronize()
    assert tlat.mass_apply_lattice.launches == before
    p = tlat.mass_apply_lattice_plain(u, Ts, Dq, lat)
    assert float((y - p).abs().max()) <= tol * float(p.abs().max())


# the runtime-size body runs the compiled instances' route (element stages
# into an E-vector, then the fixed-order assembly) with the same FMA chains
# and assembly order, so it gives their bits: the witness that a redesign
# of the compiled instances keeps the f64 bits
LAT_BITWISE = [(8, (16, 16, 16)), (2, (32, 32, 32)), (4, (16, 16, 16)),
               (2, (7, 6, 5)), (8, (5, 2, 3)), (2, (8, 2, 2)), (1, (3, 9, 11)),
               (3, (3, 3, 5)), (6, (2, 3, 3)), (2, (5, 19)), (8, (4, 3))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("C", ["dim", 1])
@pytest.mark.parametrize("order,dims", LAT_BITWISE,
                         ids=[f"p{o}-{'x'.join(map(str, d))}"
                              for o, d in LAT_BITWISE])
def test_lattice_mass_kernel_keeps_the_runtime_bodys_bits(order, dims, C,
                                                          dtype):
    """The compiled instances give the runtime-size body's output bit for
    bit, in f64 and f32, at the cells' lattices and at ragged ones."""
    from laghos_tpu_torch.ops import kernels

    dev = _card()
    C = len(dims) if C == "dim" else C
    u, Ts, Dq, lat = _lattice_operands(order, dims, C, dtype, dev, 7)
    tab = tlat.lattice_table(Ts)
    y = tlat.mass_apply_lattice(u, Ts, Dq, lat)
    yr = torch.empty_like(u)
    ye = torch.empty((C, int(np.prod(dims)), tab.nd1 ** len(dims)),
                     dtype=dtype, device=dev)
    kernels.launch_lattice_mass(u, Dq, tab.B, tab.host, ye, yr, C=C,
                                elems=tab.elems, nd1=tab.nd1, nq1=tab.nq1,
                                rt=True)
    torch.cuda.synchronize()
    assert torch.equal(y, yr)


@pytest.mark.cuda
def test_lattice_mass_kernel_never_falls_back(monkeypatch):
    """CUDA tensors go to the kernel, never to the twin; another dtype is
    refused (ValueError) and a size beyond the shared memory a block may
    have raises, neither counted."""
    dev = _card()
    u, Ts, Dq, lat = _lattice_operands(2, (3, 2, 2), 3, torch.float64, dev)
    ref = tlat.mass_apply_lattice_plain(u, Ts, Dq, lat)

    def refuse(*a, **k):
        raise AssertionError("the plain twin ran for a CUDA tensor")

    monkeypatch.setattr(tlat, "mass_apply_lattice_plain", refuse)
    before = tlat.mass_apply_lattice.launches
    y = tlat.mass_apply_lattice(u, Ts, Dq, lat)
    torch.cuda.synchronize()
    assert tlat.mass_apply_lattice.launches == before + 1
    assert float((y - ref).abs().max()) <= 1e-13 * float(ref.abs().max())
    with pytest.raises(ValueError):
        tlat.mass_apply_lattice(u.half(), [T.half() for T in Ts], Dq.half(),
                                lat)
    big = _lattice_operands(13, (1, 1, 1), 1, torch.float64, dev)
    with pytest.raises(RuntimeError, match="shared memory"):
        tlat.mass_apply_lattice(*big)
    assert tlat.mass_apply_lattice.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lattice_mass_kernel_on_hydro_matches_cpu(dtype):
    """The velocity CG's operator of a lattice Hydro (3D Sedov at rs1,
    Q2-Q1) on the card against the same Hydro's on the CPU (the twin)."""
    dev = _card()
    m = tmesh.uniform_refine(tmesh.cartesian(3, (2, 2, 2), (1.0, 1.0, 1.0)))
    hc = Hydro(m, Options(problem=1), dtype=dtype, device="cpu")
    hd = Hydro(m, Options(problem=1), dtype=dtype, device=dev)
    assert hc._lat is not None and hd._lat is not None
    u = torch.tensor(np.random.default_rng(6).standard_normal((3, hc.ndof)),
                     dtype=dtype)
    before = tlat.mass_apply_lattice.launches
    y = hd._h1_apply_bc(u.to(dev)).cpu()
    assert tlat.mass_apply_lattice.launches == before + 1
    ref = hc._h1_apply_bc(u)
    tol = 1e-13 if dtype == torch.float64 else 1e-5
    assert float((y - ref).abs().max()) <= tol * float(ref.abs().max())
