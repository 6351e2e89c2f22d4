"""The hand-written CUDA kernels (element, q-lattice and packed layouts of
csrc/qphys.cu, f64 and f32; the Ozaki split of csrc/split.cu) against their
plain PyTorch versions, on the card; the Ozaki int8 products of
ops/omm.py and the full-assembly mass product of ops/assemble.py on the
card against the same products on the CPU.  This file imports neither JAX
nor `laghos_tpu`, so it also runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Without a CUDA card every test skips.
"""

import numpy as np
import pytest
import torch

from laghos_tpu_torch.fem import mesh as tmesh
from laghos_tpu_torch.hydro import Hydro, Options
from laghos_tpu_torch.ops import lattice as tlat
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
    300-iteration cap and at a converging tolerance."""
    from laghos_tpu_torch.amr.forest import Forest
    from laghos_tpu_torch.amr.solver import AMRHydro
    from laghos_tpu_torch.solvers.cg import cg

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
                  else list(reads), graph=g) for g in (False, True)]
        assert torch.equal(res[0].x, res[1].x), tol
        assert torch.equal(res[0].iters, res[1].iters), tol
