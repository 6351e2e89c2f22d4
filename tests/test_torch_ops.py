"""Element ops of the PyTorch port against the JAX package, on the CPU:
the pointwise physics (plain version of the CUDA kernel), the eigen-solve,
the q-update, the force pair, the mass operators and CG."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laghos_tpu import data as jdata
from laghos_tpu.fem import mesh as jmesh
from laghos_tpu.hydro import Hydro as JHydro
from laghos_tpu.hydro import Options as JOptions
from laghos_tpu.ops import force as jforce
from laghos_tpu.ops import mass as jmass
from laghos_tpu.ops import pallas_qphys as jpallas
from laghos_tpu.ops import qphys as jqphys
from laghos_tpu.ops import qupdate as jqup
from laghos_tpu.ops import smallmat as jsmall
from laghos_tpu.solvers.cg import cg as jcg
from laghos_tpu_torch import data as tdata
from laghos_tpu_torch.fem import mesh as tmesh
from laghos_tpu_torch.hydro import Hydro as THydro
from laghos_tpu_torch.hydro import Options as TOptions
from laghos_tpu_torch.interop import state_from_numpy
from laghos_tpu_torch.ops import force as tforce
from laghos_tpu_torch.ops import mass as tmass
from laghos_tpu_torch.ops import qphys as tqphys
from laghos_tpu_torch.ops import qupdate as tqup
from laghos_tpu_torch.ops import smallmat as tsmall
from laghos_tpu_torch.solvers.cg import cg as tcg

torch.set_num_threads(1)

MESH = {2: "square01_quad", 3: "cube01_hex"}
_PAIRS = {}


def _pair(dim, problem=1):
    """(port Hydro, JAX Hydro, perturbed state as numpy) on the builtin
    mesh refined once; the state is made from a numpy seed."""
    key = (dim, problem)
    if key not in _PAIRS:
        mt = tmesh.uniform_refine(tdata.get_mesh(MESH[dim]))
        mj = jmesh.uniform_refine(jdata.get_mesh(MESH[dim]))
        ht = THydro(mt, TOptions(problem=problem, cg_tol=1e-14,
                                 structured_el=False, lattice_ops=False,
                                 precond="jacobi"), device="cpu")
        hj = JHydro(mj, JOptions(problem=problem, cg_tol=1e-14,
                                 structured_el=False, lattice_ops=False,
                                 precond="jacobi"))
        rng = np.random.default_rng(7)
        S0 = {k: np.asarray(v) for k, v in hj.S0.items()}
        S = {"x": S0["x"] + 0.01 * rng.normal(size=S0["x"].shape),
             "v": 0.1 * rng.normal(size=S0["v"].shape),
             "e": np.abs(S0["e"]) + 0.5}
        _PAIRS[key] = (ht, hj, S)
    return _PAIRS[key]


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


# ------------------------------------------------ pointwise physics -----
def _qdata(ht, S, *, inject=True):
    """3D q-data of the port at state S, with inverted and NaN points."""
    St = state_from_numpy(S, device="cpu")
    x_e, v_e = ht._gather_e(St["x"]), ht._gather_e(St["v"])
    t = ht.tables
    J9 = tqup._grad9(x_e, t["H1B"], t["H1G"], ht.nd1, ht.NQ)
    dV9 = tqup._grad9(v_e, t["H1B"], t["H1G"], ht.nd1, ht.NQ)
    et = St["e"].reshape((ht.NE,) + (ht.l1d,) * 3)
    from laghos_tpu_torch.ops import tensor as ttensor

    e_q = ttensor.eval_values(et, t["L2B"], 3).reshape(ht.NE, ht.NQ)
    if inject:
        J9[:, 3, 5] *= -1.0              # detJ < 0
        J9[:, 10, 0] *= -1.0
        J9[4, 20, 7] = float("nan")      # NaN geometry
        e_q[30, 11] = float("nan")       # NaN energy
    return dict(J9=J9.contiguous(), dV9=dV9.contiguous(), J0i9=ht.Jac0inv_t,
                e_q=e_q.contiguous(), rw=ht.rho0DetJ0w_t, gamma=ht.gamma_t,
                winv=ht.tables["Winv"])


def _plain(ht, q, **kw):
    return tqphys.physics_3d_plain(
        q["J9"], q["dV9"], q["J0i9"], q["e_q"], q["rw"], q["gamma"],
        q["winv"], h0_e=ht.h0, h1order=2.0, cfl=0.5, **kw)


def _assert_same(s_t, d_t, s_j, d_j, tol):
    s_j, d_j = np.asarray(s_j), np.asarray(d_j)
    s_t, d_t = s_t.numpy(), d_t.numpy()
    np.testing.assert_array_equal(np.isnan(s_t), np.isnan(s_j))
    np.testing.assert_array_equal(d_t == 0, d_j == 0)
    fin = ~np.isnan(s_j)
    scale = np.abs(s_j[fin]).max()
    assert np.abs(s_t[fin] - s_j[fin]).max() <= tol * scale
    good = d_j > 0
    assert abs(d_t[good].min() - d_j[good].min()) <= tol * d_j[good].min()
    assert (d_t == 0).sum() == 4


@pytest.mark.parametrize("use_vorticity", [False, True])
def test_physics_3d_plain_matches_jax(use_vorticity):
    ht, hj, S = _pair(3)
    q = _qdata(ht, S)
    s_t, d_t = _plain(ht, q, use_vorticity=use_vorticity)
    n = {k: v.numpy() for k, v in q.items()}

    @jax.jit
    def ref(J9, dV9, J0i9, e_q, rw, gamma, winv):
        s, d, _ = jqphys.physics_3d(
            tuple(J9), tuple(dV9), tuple(J0i9), e_q, rw, gamma[:, None],
            winv[None, :], h0_e=jnp.full_like(e_q, ht.h0), h1order=2.0,
            cfl=0.5, use_vorticity=use_vorticity)
        return jnp.stack(s), d

    s_j, d_j = ref(*(n[k] for k in ("J9", "dV9", "J0i9", "e_q", "rw",
                                    "gamma", "winv")))
    _assert_same(s_t, d_t, s_j, d_j, 1e-14)


def test_physics_3d_plain_inviscid_matches_jax():
    ht, hj, S = _pair(3)
    q = _qdata(ht, S)
    s_t, d_t = _plain(ht, q, use_viscosity=False)
    n = {k: v.numpy() for k, v in q.items()}
    zero = tuple(np.zeros_like(n["e_q"]) for _ in range(9))
    s_j, d_j, _ = jqphys.physics_3d(
        tuple(n["J9"]), zero, tuple(n["J0i9"]), n["e_q"], n["rw"],
        n["gamma"][:, None], n["winv"][None, :],
        h0_e=np.full_like(n["e_q"], ht.h0), h1order=2.0, cfl=0.5,
        use_viscosity=False)
    _assert_same(s_t, d_t, jnp.stack(s_j), d_j, 1e-14)


def test_physics_3d_plain_matches_pallas_interpret():
    """Against the TPU kernel itself, run in interpret mode as
    tests/test_qphys.py runs it."""
    ht, hj, S = _pair(3)
    q = _qdata(ht, S)
    s_t, d_t = _plain(ht, q)
    n = {k: v.numpy() for k, v in q.items()}
    s_j, d_j, _ = jpallas.physics_3d_pallas9(
        tuple(n["J9"]), tuple(n["dV9"]), tuple(n["J0i9"]), n["e_q"],
        n["rw"], n["gamma"][:, None], np.asarray(hj.tables["W"]), h0=ht.h0,
        h1order=2.0, cfl=0.5, interpret=True)
    _assert_same(s_t, d_t, jnp.stack(s_j), d_j, 1e-13)


def test_physics_3d_wrapper_cpu_runs_plain_and_checks_inputs():
    ht, hj, S = _pair(3)
    q = _qdata(ht, S, inject=False)
    kw = dict(h0_e=ht.h0, h1order=2.0, cfl=0.5)
    args = [q[k] for k in ("J9", "dV9", "J0i9", "e_q", "rw", "gamma",
                           "winv")]
    before = tqphys.physics_3d.launches
    s_w, d_w = tqphys.physics_3d(*args, **kw)
    s_p, d_p = tqphys.physics_3d_plain(*args, **kw)
    assert torch.equal(s_w, s_p) and torch.equal(d_w, d_p)
    assert tqphys.physics_3d.launches == before   # no kernel on the CPU
    with pytest.raises(TypeError):
        tqphys.physics_3d(*[a.float() if i == 3 else a
                            for i, a in enumerate(args)], **kw)
    with pytest.raises(ValueError):
        tqphys.physics_3d(args[0][:, :, :-1], *args[1:], **kw)
    with pytest.raises(ValueError):
        tqphys.physics_3d(args[0].transpose(1, 2).contiguous()
                          .transpose(1, 2), *args[1:], **kw)


# ------------------------------------------------------ eigen-solve -----
def _degenerate_batch():
    rng = np.random.default_rng(3)
    mats = [np.zeros((3, 3)), np.eye(3), np.diag([1.0, 1.0, 2.0]),
            np.diag([2.0, 1.0, 1.0]), np.diag([3.0, 1.0, 3.0]),
            np.diag([1.0, 1.0 + 1e-10, 3.0]), np.diag([-2.0, -2.0, -2.0]),
            np.ones((3, 3))]
    for D in ([1.0, 1.0, 2.0], [2.0, 2.0, 1.0], [0.5, 0.5 + 1e-9, -1.0],
              [1.0, 2.0, 3.0]):
        Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        mats.append(Q @ np.diag(D) @ Q.T)
    A = np.stack(mats)
    return 0.5 * (A + A.transpose(0, 2, 1))


def test_eig3s_hybrid_degenerate_spectra():
    A = _degenerate_batch()
    comps = [A[:, 0, 0], A[:, 1, 1], A[:, 2, 2], A[:, 0, 1], A[:, 0, 2],
             A[:, 1, 2]]
    mu_t, vec_t = tsmall.eig3s_hybrid(*(_t(c) for c in comps))
    mu_j, vec_j = jax.jit(jsmall.eig3s_hybrid)(*comps)
    scale = np.abs(A).max(axis=(1, 2))
    mu_t = mu_t.numpy()
    assert np.all(np.abs(mu_t - np.asarray(mu_j)) <= 1e-14 * scale)
    lam = np.linalg.eigvalsh(A)
    assert np.all(np.abs(mu_t - lam[:, 0]) <= 1e-13 * scale)
    e = torch.stack(vec_t, -1).numpy()
    np.testing.assert_allclose(e, np.stack(vec_j, -1), atol=1e-6)
    res = np.linalg.norm(np.einsum("bij,bj->bi", A, e) - mu_t[:, None] * e,
                         axis=1)
    assert np.all(res <= 1e-6 * np.maximum(scale, 1e-300))
    gap = lam[:, 1] - lam[:, 0]
    sep = gap > 1e-3 * scale
    assert np.all(res[sep] <= 1e-12 * scale[sep])


# --------------------------------------------------------- q-update -----
def test_qupdate3d_matches_jax():
    ht, hj, S = _pair(3)
    St = state_from_numpy(S, device="cpu")
    s_t, dt_t = ht._qupdate(St)
    s_j, dt_j = jax.jit(hj._qupdate)({k: jnp.asarray(v)
                                      for k, v in S.items()})
    assert _rel(s_t.numpy(), jnp.stack(s_j)) <= 1e-14
    assert float(dt_t) == pytest.approx(float(dt_j), rel=1e-14)


@pytest.mark.parametrize("problem", [1, 7])
def test_qupdate_2d_matches_jax(problem):
    ht, hj, S = _pair(2, problem)
    St = state_from_numpy(S, device="cpu")
    s_t, dt_t = ht._qupdate(St)
    s_j, dt_j = jax.jit(hj._qupdate)({k: jnp.asarray(v)
                                      for k, v in S.items()})
    assert _rel(s_t.numpy(), s_j) <= 1e-14
    assert float(dt_t) == pytest.approx(float(dt_j), rel=1e-14)


# ------------------------------------------------------------ force -----
@pytest.mark.parametrize("dim", [2, 3])
def test_force_pair_parity_and_adjointness(dim):
    ht, hj, S = _pair(dim)
    sJit, _ = ht._qupdate(state_from_numpy(S, device="cpu"))
    rng = np.random.default_rng(11)
    e = rng.normal(size=(ht.NE, ht.ld))
    v_e = rng.normal(size=(ht.NE, dim, ht.nd1**dim))
    tt = ht.tables
    tj = {k: hj.tables[k] for k in ("H1B", "H1G", "L2B")}
    sj = sJit.numpy()
    eps2 = ht.ftz_eps2
    if dim == 3:
        Fe = tforce.force_mult9(_t(e), sJit, tt, ftz_eps2=eps2)
        FTv = tforce.force_mult_transpose9(_t(v_e), sJit, tt)
        Fe_j = jforce.force_mult9(e, tuple(sj), tj, ftz_eps2=eps2)
        FTv_j = jforce.force_mult_transpose9(v_e, tuple(sj), tj)
    else:
        Fe = tforce.force_mult(_t(e), sJit, tt, dim=2, ftz_eps2=eps2)
        FTv = tforce.force_mult_transpose(_t(v_e), sJit, tt, dim=2)
        Fe_j = jforce.force_mult(e, sj, tj, dim=2, ftz_eps2=eps2)
        FTv_j = jforce.force_mult_transpose(v_e, sj, tj, dim=2)
    assert _rel(Fe.numpy(), Fe_j) <= 1e-14
    assert _rel(FTv.numpy(), FTv_j) <= 1e-14
    lhs = float(torch.sum(Fe * _t(v_e)))
    rhs = float(torch.sum(_t(e) * FTv))
    assert abs(lhs - rhs) <= 1e-13 * abs(lhs)


# ------------------------------------------------------------- mass -----
@pytest.mark.parametrize("dim", [2, 3])
def test_mass_apply_and_incidence_match_jax(dim):
    ht, hj, S = _pair(dim)
    rng = np.random.default_rng(5)
    u = rng.normal(size=(dim, ht.ndof))
    y_t = ht._h1_apply_bc(_t(u))
    y_j = jax.jit(hj._h1_apply_bc)(jnp.asarray(u))
    assert _rel(y_t.numpy(), y_j) <= 1e-14
    inc_t, msk_t = tmass.build_incidence(ht.h1.gather, ht.ndof)
    inc_j, msk_j = jmass.build_incidence(hj.h1.gather, hj.ndof)
    np.testing.assert_array_equal(inc_t, inc_j)
    np.testing.assert_array_equal(msk_t, msk_j)
    ue = rng.normal(size=(dim, ht.NE, ht.nd1**dim))
    by_gather = ht._assemble(_t(ue))
    by_scatter = tmass.e_to_l(_t(ue), ht.h1.gather, ht.ndof)
    assert _rel(by_gather.numpy(), by_scatter.numpy()) <= 1e-15
    e = rng.normal(size=(ht.NE, ht.ld))
    m_t = tmass.mass_apply_e(_t(e), ht.massD, ht.tables["L2B"], dim)
    m_j = jmass.mass_apply_e(e, hj.massD, hj.tables["L2B"], dim)
    assert _rel(m_t.numpy(), m_j) <= 1e-14
    M_t = tmass.l2_mass_matrices(ht.massD, ht.tables["L2B"], dim)
    M_j = jmass.l2_mass_matrices(hj.massD, hj.tables["L2B"], dim)
    assert _rel(M_t.numpy(), M_j) <= 1e-14


@pytest.mark.parametrize("dim", [2, 3])
def test_h1_mass_diag_matches_apply(dim):
    mt = tdata.get_mesh(MESH[dim])
    ht = THydro(mt, TOptions(problem=1, structured_el=False,
                             lattice_ops=False, precond="jacobi"),
                device="cpu")
    gather = torch.as_tensor(ht.h1.gather, dtype=torch.long)
    I = torch.eye(ht.ndof, dtype=torch.float64)
    M = tmass.h1_mass_apply(I, gather, ht.ndof, ht.massD, ht.tables["H1B"],
                            dim)
    diag = tmass.h1_mass_diag(ht.h1.gather, ht.ndof, ht.massD,
                              ht.tables["H1B"], dim)
    assert torch.allclose(M, M.T, rtol=0, atol=1e-15)
    assert _rel(torch.diagonal(M).numpy(), diag.numpy()) <= 1e-14
    assert _rel(1.0 / diag.numpy(), ht.h1_dinv.numpy()) == 0.0


# --------------------------------------------------------------- CG -----
@pytest.mark.parametrize("dim", [2, 3])
def test_cg_matches_jax(dim):
    ht, hj, S = _pair(dim)
    rng = np.random.default_rng(9)
    b = np.where(ht.ess_mask, 0.0, rng.normal(size=(dim, ht.ndof)))
    res_t = tcg(ht._h1_apply_bc, _t(b), 1e-12, 300,
                precond=ht._precond_velocity)
    res_j = jax.jit(lambda r: jcg(hj._h1_apply_bc, r, 1e-12, 300,
                                  precond=hj._precond_velocity))(
        jnp.asarray(b))
    np.testing.assert_array_equal(res_t.iters.numpy(), np.asarray(res_j.iters))
    assert bool(res_t.converged.all())
    assert _rel(res_t.x.numpy(), res_j.x) <= 1e-13
    # energy (L2) mass solve, no preconditioner
    e = rng.normal(size=(ht.NE, ht.ld))
    x_t, it_t = ht._cg_energy(_t(e))
    x_j, it_j = jax.jit(hj._cg_energy)(jnp.asarray(e))
    assert int(it_t) == int(it_j)
    assert _rel(x_t.numpy(), x_j) <= 1e-13
