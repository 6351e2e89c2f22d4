"""The hand-written CUDA kernels (element, q-lattice and packed layouts of
csrc/qphys.cu, f64 and f32; the Ozaki split of csrc/split.cu) against their
plain PyTorch versions, on the card, and the Ozaki int8 products of
ops/omm.py on the card against the same products on the CPU.  This file imports neither JAX nor `laghos_tpu`, so it also runs
on a machine without them:

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("visc,vort", [(True, False), (True, True),
                                       (False, False)])
def test_qphys_kernel_matches_plain(qdata, dtype, tol, visc, vort):
    h, inputs = qdata
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


def _agree(s_k, d_k, s_p, d_p, tol):
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
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("visc,vort", [(True, False), (True, True),
                                       (False, False)])
def test_qphys_lattice_kernel_matches_plain(lattice_qdata, dtype, tol, visc,
                                            vort):
    h, inputs = lattice_qdata
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
def test_qphys_packed_kernel_matches_plain(qdata, dtype, tol, visc, vort):
    h, inputs = qdata
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
    assert torch.equal(torch.isnan(v_k), torch.isnan(v_p))
    fin = ~torch.isnan(v_p)
    scale = max(float(v_p[fin].abs().max()), 1e-300)
    assert float((v_k[fin] - v_p[fin]).abs().max()) <= tol * scale


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


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("S", [8, 6, 4])
def test_split_kernel_matches_plain_bitwise(axis, S):
    dev = _card()
    A = _split_operand().to(dev)
    before = omm.split_dyn.launches
    k = omm.split_dyn(A, S, axis)
    torch.cuda.synchronize()
    assert omm.split_dyn.launches == before + 1
    p = omm.split_dyn_plain(A, S, axis)
    assert torch.equal(k.cat, p.cat)
    assert torch.equal(k.scale.view(torch.int64), p.scale.view(torch.int64))
    assert int(torch.isnan(k.scale).sum()) > 0
    c = omm.split_dyn_plain(A.cpu(), S, axis)
    assert torch.equal(k.cat.cpu(), c.cat)


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
