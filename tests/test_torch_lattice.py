"""The whole-lattice path of the PyTorch port (`laghos_tpu_torch/ops/
lattice.py`, the lattice and packed layouts of `ops/qphys.py`, and the
default `Hydro`) against the JAX package on the CPU.

Tolerances: the banded tables are built the same way and compare bit for
bit.  Every contraction is a `torch.tensordot` here and an XLA dot in the
JAX package; on the CPU the two order the K-sums differently, so results
differ by a few ulps per contraction (observed up to ~1e-14 relative in
the q-update of a random state, whose f32 eigen-sweeps amplify the
difference at near-degenerate points).  1e-13 leaves an order of
magnitude of room; the JAX package's own lattice-vs-E-form bound is 1e-10
(tests/test_lattice.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laghos_tpu import data as jdata
from laghos_tpu.fem import mesh as jmesh
from laghos_tpu.hydro import Hydro as JHydro
from laghos_tpu.hydro import Options as JOptions
from laghos_tpu.ops import lattice as jlat
from laghos_tpu.ops import pallas_qphys as jpallas
from laghos_tpu.solvers.cg import cg as jcg
from laghos_tpu_torch import cli, driver
from laghos_tpu_torch import data as tdata
from laghos_tpu_torch.fem import mesh as tmesh
from laghos_tpu_torch.hydro import Hydro as THydro
from laghos_tpu_torch.hydro import Options as TOptions
from laghos_tpu_torch.interop import (lattice_arrays, state_from_numpy,
                                      state_to_numpy)
from laghos_tpu_torch.ops import lattice as tlat
from laghos_tpu_torch.ops import mass as tmass
from laghos_tpu_torch.ops import qphys as tqphys
from laghos_tpu_torch.solvers.cg import cg as tcg

torch.set_num_threads(1)

_PAIRS = {}


def _pair(name, rs, **kw):
    """(port Hydro, JAX Hydro, perturbed state as numpy), both with the
    default operator options (plus `kw`); the state is made from a numpy
    seed."""
    key = (name, rs, tuple(sorted(kw.items())))
    if key not in _PAIRS:
        mt, mj = tdata.get_mesh(name), jdata.get_mesh(name)
        for _ in range(rs):
            mt, mj = tmesh.uniform_refine(mt), jmesh.uniform_refine(mj)
        # cg_tol 1e-12: at 1e-14 the stopping test sits at round-off and
        # an iteration count can differ by one between the packages
        opt = dict(problem=1, cg_tol=1e-12, **kw)
        ht = THydro(mt, TOptions(**opt), device="cpu")
        hj = JHydro(mj, JOptions(**opt))
        assert ht._lat is not None and hj._lat is not None
        rng = np.random.default_rng(1)
        S0 = {k: np.asarray(v) for k, v in hj.S0.items()}
        S = {"x": S0["x"] + 0.005 * rng.normal(size=S0["x"].shape),
             "v": np.where(ht.ess_mask, 0.0,
                           0.1 * rng.normal(size=S0["v"].shape)),
             "e": S0["e"] + 0.5}
        _PAIRS[key] = (ht, hj, S)
    return _PAIRS[key]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


_MESHES = [("cube01_hex", 1), ("box01_hex", 0), ("square01_quad", 1),
           ("rectangle01_quad", 0)]


# ---------------------------------------------------- lattice arrays -----
@pytest.mark.parametrize("name,rs", _MESHES)
def test_lattice_arrays_match_jax(name, rs):
    ht, hj, _ = _pair(name, rs)
    a = lattice_arrays(ht)
    lj = hj._lat
    d = ht.dim
    assert a["dims"] == tuple(hj._sm.dims)
    assert a["lat_dims"] == tuple(hj._lat_dims)
    for k in ("Ts", "Tg"):
        assert len(a[k]) == d
        for x, y in zip(a[k], lj[k]):
            np.testing.assert_array_equal(x, np.asarray(y))
    J0 = f"J0i{d * d}"
    for k in ("Dq", "rw", "gam", "winv", J0):
        ref = np.stack(lj[k]) if k == J0 else np.asarray(lj[k])
        assert a[k].shape == ref.shape, k
        assert _rel(a[k], ref) <= 1e-14, k
    # Sedov on a box: the free sets are axis products, the kron factors
    # exist in both packages and agree
    assert len(a["kron"]) == d
    for x, y in zip(a["kron"], lj["kron"]):
        assert _rel(x, y) <= 1e-14
    assert ht._lat["kron_relerr"] < 1e-10


def test_lattice_arrays_q4q3_and_f32():
    """The ns4 shape (Q4-Q3) builds the same lattice; an f32 run keeps
    every lattice tensor in f32; no lattice -> None."""
    mt, mj = tdata.get_mesh("cube01_hex"), jdata.get_mesh("cube01_hex")
    opt = dict(problem=1, order_v=4, order_e=3)
    ht = THydro(mt, TOptions(**opt), device="cpu")
    hj = JHydro(mj, JOptions(**opt))
    a = lattice_arrays(ht)
    assert a["lat_dims"] == tuple(hj._lat_dims) == (9, 9, 9)
    for x, y in zip(a["Tg"], hj._lat["Tg"]):
        np.testing.assert_array_equal(x, np.asarray(y))
    assert _rel(a["Dq"], hj._lat["Dq"]) <= 1e-14
    h32 = THydro(tdata.get_mesh("cube01_hex"), TOptions(problem=1),
                 dtype=torch.float32, device="cpu")
    for k, v in h32._lat.items():
        for t in (v if isinstance(v, tuple) else (v,)):
            if isinstance(t, torch.Tensor):
                assert t.dtype == torch.float32, k
    hg = THydro(tdata.get_mesh("cube01_hex"),
                TOptions(problem=1, lattice_ops=False), device="cpu")
    assert lattice_arrays(hg) is None


# -------------------------------------------------------- mass apply -----
@pytest.mark.parametrize("dim", [2, 3])
def test_mass_apply_lattice_matches_jax_and_gather(dim):
    """Against JAX's lattice apply, and against the port's gather-path
    operator (element mass applies + incidence assembly) on the same
    raster numbering, which sums in another order."""
    ht, hj, _ = _pair(*{2: ("square01_quad", 2), 3: ("cube01_hex", 1)}[dim])
    rng = np.random.default_rng(5)
    u = rng.normal(size=(dim, ht.ndof))
    y_t = ht._h1_apply_bc(_t(u)).numpy()
    assert _rel(y_t, jax.jit(hj._h1_apply_bc)(jnp.asarray(u))) <= 1e-14
    y_raw = tlat.mass_apply_lattice(_t(u), ht._lat["Ts"], ht._lat["Dq"],
                                    ht._lat_dims)
    inc, msk = tmass.build_incidence(ht.h1.gather, ht.ndof)
    ue = tmass.mass_apply_e(ht._l_to_e(_t(u)), ht.massD, ht.tables["H1B"],
                            dim)
    y_g = tmass.e_to_l_gather(ue, torch.as_tensor(inc, dtype=torch.long),
                              _t(msk))
    assert _rel(y_raw.numpy(), y_g.numpy()) <= 1e-13


# ---------------------------------------------- q-update and force pair --
@pytest.mark.parametrize("name,rs", _MESHES)
def test_qupdate_and_force_lattice_match_jax(name, rs):
    """The whole-lattice q-update (banded gradients + lattice-layout
    physics), F.1 and F^T.v against JAX's lattice functions, on cubic and
    non-cubic raster meshes (a swapped axis cannot hide on 4x2x2 or 7x3)."""
    ht, hj, S = _pair(name, rs)
    St, Sj = state_from_numpy(S), {k: jnp.asarray(v) for k, v in S.items()}
    s_t, d_t = ht._qupdate(St)
    s_j, d_j = hj._jq(Sj)
    assert s_t.shape == (ht.dim ** 2,) + tuple(s_j[0].shape)
    assert _rel(s_t.numpy(), np.stack(s_j)) <= 1e-13
    assert float(d_t) == pytest.approx(float(d_j), rel=1e-13)
    assert _rel(ht._force_rhs_raw(s_t).numpy(), hj._jforce1(s_j)) <= 1e-13
    assert _rel(ht._force_transpose(s_t, St["v"]).numpy(),
                hj._jfT(s_j, Sj["v"])) <= 1e-13


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("visc,vort", [(True, True), (False, False)])
def test_qupdate_lattice_branches_match_jax(dim, visc, vort):
    """The vorticity and inviscid branches, called directly."""
    ht, hj, S = _pair(*{2: ("rectangle01_quad", 0), 3: ("box01_hex", 0)}[dim])
    St = state_from_numpy(S)
    ft, fj = ((tlat.qupdate3d_lattice, jlat.qupdate3d_lattice) if dim == 3
              else (tlat.qupdate2d_lattice, jlat.qupdate2d_lattice))
    kw = dict(h1order=2.0, cfl=0.5, use_viscosity=visc, use_vorticity=vort)
    s_t, d_t = ft(St["x"], St["v"], St["e"], ht._lat, ht._lat_dims,
                  ht._edims, ht.tables, **kw)
    s_j, d_j = jax.jit(lambda x, v, e: fj(
        x, v, e, hj._lat, hj._lat_dims, hj._edims, hj.tables, **kw))(
        *(jnp.asarray(S[k]) for k in ("x", "v", "e")))
    assert _rel(s_t.numpy(), np.stack(s_j)) <= 1e-13
    assert float(d_t) == pytest.approx(float(d_j), rel=1e-13)


def test_qlattice_layout_roundtrip():
    rng = np.random.default_rng(0)
    for dims, to_l, to_e, jto_l in (
            ((4, 2, 3), tlat.eq_to_qlattice, tlat.qlattice_to_eq,
             jlat.eq_to_qlattice),
            ((7, 3), tlat.eq_to_qlattice_2d, tlat.qlattice_to_eq_2d,
             jlat.eq_to_qlattice_2d)):
        x = rng.normal(size=(int(np.prod(dims)), 3 ** len(dims)))
        q = to_l(_t(x), dims, 3)
        np.testing.assert_array_equal(q.numpy(), jto_l(x, dims, 3))
        np.testing.assert_array_equal(to_e(q, dims, 3).numpy(), x)


# ------------------------------------------------------------- kron -----
@pytest.mark.parametrize("dim", [2, 3])
def test_kron_preconditioner_matches_jax(dim):
    """Factors and apply against JAX; symmetric and positive on the free
    subspace; exact inverse on Sedov's affine raster mesh, so CG takes at
    most 3 iterations per component with JAX's iteration counts."""
    ht, hj, _ = _pair(*{2: ("square01_quad", 2), 3: ("cube01_hex", 1)}[dim])
    Ts = tuple(t.numpy() for t in ht._lat["Ts"])
    Dq = ht._lat["Dq"].numpy()
    for (At, et), (Aj, ej) in zip(tlat.kron_mass_factors(Dq, Ts),
                                  jlat.kron_mass_factors(Dq, Ts)):
        assert _rel(At, Aj) <= 1e-14 and et == pytest.approx(ej, abs=1e-15)
    rng = np.random.default_rng(3)
    r1, r2 = rng.normal(size=(2, dim, ht.ndof))
    p1 = ht._precond_velocity(_t(r1)).numpy()
    assert _rel(p1, jax.jit(hj._precond_velocity)(jnp.asarray(r1))) <= 1e-14
    p2 = ht._precond_velocity(_t(r2)).numpy()
    a, b = float(np.sum(p1 * r2)), float(np.sum(r1 * p2))
    assert abs(a - b) <= 1e-12 * abs(a)
    r1f = np.where(ht.ess_mask, 0.0, r1)
    assert float(np.sum(ht._precond_velocity(_t(r1f)).numpy() * r1f)) > 0.0
    b = np.where(ht.ess_mask, 0.0, rng.normal(size=(dim, ht.ndof)))
    res_t = tcg(ht._h1_apply_bc, _t(b), 1e-12, 300,
                precond=ht._precond_velocity)
    res_j = jax.jit(lambda r: jcg(hj._h1_apply_bc, r, 1e-12, 300,
                                  precond=hj._precond_velocity))(
        jnp.asarray(b))
    np.testing.assert_array_equal(res_t.iters.numpy(), np.asarray(res_j.iters))
    assert int(res_t.iters.max()) <= 3
    assert _rel(res_t.x.numpy(), res_j.x) <= 1e-13


def test_kron_absent_when_free_set_not_axis_product():
    ht, _, _ = _pair("box01_hex", 0)
    mask = np.array(ht.ess_mask, bool)
    mask[0, ht.ndof // 2] = True        # one interior dof constrained
    Ts = tuple(t.numpy() for t in ht._lat["Ts"])
    Dq = ht._lat["Dq"].numpy()
    assert tlat.build_kron_precond(mask, ht._lat_dims, Dq, Ts) is None
    assert jlat.build_kron_precond(mask, ht._lat_dims, Dq, Ts) is None
    hjac = THydro(tdata.get_mesh("box01_hex"),
                  TOptions(problem=1, precond="jacobi"), device="cpu")
    assert "kron" not in hjac._lat
    r = _t(np.random.default_rng(0).normal(size=(3, hjac.ndof)))
    assert torch.equal(hjac._precond_velocity(r), r * hjac.h1_dinv[None, :])


# ------------------------------------------- pointwise physics layouts ---
def _lattice_qdata(ht, S):
    """q-lattice inputs of the 3D lattice physics at state S, with
    inverted and NaN points."""
    St = state_from_numpy(S)
    lat, dims = ht._lat, ht._lat_dims
    J9 = torch.stack(tlat.grad9_lattice(St["x"].reshape((3,) + dims),
                                        lat["Ts"], lat["Tg"]))
    dV9 = torch.stack(tlat.grad9_lattice(St["v"].reshape((3,) + dims),
                                         lat["Ts"], lat["Tg"]))
    e_q = tlat.energy_qlattice(St["e"], ht._edims, ht.tables, 3)
    J9[:, 1, 2, 3] *= -1.0                 # detJ < 0
    J9[:, 5, 0, 7] *= -1.0
    J9[4, 6, 6, 1] = float("nan")          # NaN geometry
    e_q[2, 7, 4] = float("nan")            # NaN energy
    return [J9.contiguous(), dV9.contiguous(), lat["J0i9"], e_q, lat["rw"],
            lat["gam"], lat["winv"]]


def _assert_same(s_t, d_t, s_j, d_j, tol, n_zero=4):
    s_t, d_t = np.asarray(s_t), np.asarray(d_t)
    s_j, d_j = np.asarray(s_j), np.asarray(d_j)
    np.testing.assert_array_equal(np.isnan(s_t), np.isnan(s_j))
    np.testing.assert_array_equal(d_t == 0, d_j == 0)
    assert (d_t == 0).sum() == n_zero
    fin = ~np.isnan(s_j)
    assert np.abs(s_t[fin] - s_j[fin]).max() <= tol * np.abs(s_j[fin]).max()
    good = d_j > 0
    assert abs(d_t[good].min() - d_j[good].min()) <= tol * d_j[good].min()


def test_lattice_physics_plain_matches_pallas_flat_interpret():
    """The plain lattice-layout physics against kernel #2
    (physics_3d_pallas_flat) in interpret mode, on the rs0 q-lattice
    (8^3 points as 64 x 8 rows), with inverted and NaN points."""
    ht, hj, S = _pair("cube01_hex", 0)
    args = _lattice_qdata(ht, S)
    kw = dict(h0=ht.h0, h1order=2.0, cfl=0.5)
    s_t, d_t = tqphys.physics_3d_lattice_plain(*args, **kw)
    n = [a.numpy() for a in args]

    def r2(a):
        return a.reshape(64, 8)

    s_j, d_j, _ = jpallas.physics_3d_pallas_flat(
        tuple(r2(a) for a in n[0]), tuple(r2(a) for a in n[1]),
        tuple(r2(a) for a in n[2]), r2(n[3]), r2(n[4]), r2(n[5]), r2(n[6]),
        interpret=True, **kw)
    _assert_same(s_t.reshape(9, 64, 8), d_t.reshape(64, 8), np.stack(s_j),
                 d_j, 1e-13)


@pytest.mark.parametrize("vort", [False, True])
def test_packed_physics_plain_matches_pallas_interpret(vort):
    """The plain packed-layout physics, viscosity coefficient included,
    against kernel #1 (physics_3d_pallas) in interpret mode."""
    ht, hj, S = _pair("cube01_hex", 0)
    args = _lattice_qdata(ht, S)
    dims, nq1 = ht._edims, ht.nq1

    def packed(A9):
        e = torch.stack([tlat.qlattice_to_eq(a, dims, nq1) for a in A9], -1)
        return e.reshape(e.shape[0], e.shape[1], 3, 3).contiguous()

    J, dV = packed(args[0]), packed(args[1])
    J0i = packed(ht._lat["J0i9"])
    e_q = tlat.qlattice_to_eq(args[3], dims, nq1).contiguous()
    rw = tlat.qlattice_to_eq(args[4], dims, nq1).contiguous()
    W = ht.tables["W"]
    kw = dict(h0=ht.h0, h1order=2.0, cfl=0.5, use_vorticity=vort)
    s_t, d_t, v_t = tqphys.physics_3d_packed_plain(J, dV, J0i, e_q, rw,
                                                   ht.gamma_t, W, **kw)
    s_j, d_j, v_j = jpallas.physics_3d_pallas(
        J.numpy(), dV.numpy(), J0i.numpy(), e_q.numpy(), rw.numpy(),
        ht.gamma_t.numpy(), W.numpy(), interpret=True, **kw)
    _assert_same(s_t, d_t, s_j, d_j, 1e-13)
    v_t, v_j = v_t.numpy(), np.asarray(v_j)
    np.testing.assert_array_equal(np.isnan(v_t), np.isnan(v_j))
    fin = ~np.isnan(v_j)
    assert np.abs(v_t[fin] - v_j[fin]).max() <= 1e-13 * np.abs(v_j[fin]).max()


def test_layout_wrappers_run_plain_on_cpu_and_check_inputs():
    ht, hj, S = _pair("cube01_hex", 0)
    args = _lattice_qdata(ht, S)
    kw = dict(h0=ht.h0, h1order=2.0, cfl=0.5)
    before = (tqphys.physics_3d_lattice.launches,
              tqphys.physics_3d_packed.launches)
    s_w, d_w = tqphys.physics_3d_lattice(*args, **kw)
    s_p, d_p = tqphys.physics_3d_lattice_plain(*args, **kw)
    assert torch.equal(torch.isnan(s_w), torch.isnan(s_p))
    fin = ~torch.isnan(s_p)
    assert torch.equal(s_w[fin], s_p[fin]) and torch.equal(d_w, d_p)
    with pytest.raises(TypeError):
        tqphys.physics_3d_lattice(*args[:3], args[3].float(), *args[4:],
                                  **kw)
    with pytest.raises(ValueError):
        tqphys.physics_3d_lattice(args[0][:, :-1].contiguous(), *args[1:],
                                  **kw)
    with pytest.raises(ValueError):
        tqphys.physics_3d_lattice(*args[:6], args[6].transpose(0, 1), **kw)
    NE, NQ = ht.NE, ht.NQ
    J = torch.ones((NE, NQ, 3, 3), dtype=torch.float64)
    one = torch.ones((NE, NQ), dtype=torch.float64)
    s, d, v = tqphys.physics_3d_packed(J, J, J, one, one, ht.gamma_t,
                                       ht.tables["W"], **kw)
    assert s.shape == (NE, NQ, 3, 3) and v.shape == d.shape == (NE, NQ)
    with pytest.raises(ValueError):
        tqphys.physics_3d_packed(J[:, :-1].contiguous(), J, J, one, one,
                                 ht.gamma_t, ht.tables["W"], **kw)
    assert (tqphys.physics_3d_lattice.launches,
            tqphys.physics_3d_packed.launches) == before


# ------------------------------------------------------ the whole slice --
@pytest.mark.parametrize("precond", ["jacobi", "kron"])
@pytest.mark.parametrize("name,rs", [("cube01_hex", 1), ("box01_hex", 0)])
def test_steps_match_jax_default_hydro(name, rs, precond):
    """3 memoized `advance` steps of the port's default Hydro against the
    JAX package's default Hydro: states, dt estimates and CG counts."""
    ht, hj, S = _pair(name, rs, precond=precond)
    assert ("kron" in ht._lat) == (precond == "kron") == ("kron" in hj._lat)
    St, Sj = state_from_numpy(S), {k: jnp.asarray(v) for k, v in S.items()}
    dt_t, sj_t = ht.dt_estimate_full(St)
    dt_j, sj_j = hj.dt_estimate_full(Sj)
    dt = 0.5 * float(dt_j)
    for _ in range(3):
        St, est_t, (h1_t, l2_t), sj_t = ht.advance(St, dt, sJit1=sj_t)
        Sj, est_j, (h1_j, l2_j), sj_j = hj.advance(Sj, dt, sJit1=sj_j)
        assert (int(h1_t), int(l2_t)) == (int(h1_j), int(l2_j))
        if precond == "kron":
            assert int(h1_t) <= 4 * 3 * 3   # RK4: 4 solves x 3 components
        assert float(est_t) == pytest.approx(float(est_j), rel=1e-12)
        Sn = state_to_numpy(St)
        for k in ("x", "v", "e"):
            assert _rel(Sn[k], Sj[k]) <= 1e-12, k


def test_q4q3_lattice_step_matches_jax():
    """The ns4 shape (Q4-Q3) constructs and steps on the lattice path.

    The L2 (energy) CG count may differ by up to 2: the order-3 Bernstein
    mass is ill-conditioned and its CG count rides on the rounding of
    the element contractions (a random right-hand side takes 40 vs 42
    iterations, on either operator path).  The H1 counts and the
    converged states agree."""
    mt, mj = tdata.get_mesh("cube01_hex"), jdata.get_mesh("cube01_hex")
    opt = dict(problem=1, order_v=4, order_e=3, ode_solver=7, cg_tol=1e-12)
    ht = THydro(mt, TOptions(**opt), device="cpu")
    hj = JHydro(mj, JOptions(**opt))
    S = {k: np.asarray(v) for k, v in hj.S0.items()}
    St, Sj = state_from_numpy(S), {k: jnp.asarray(v) for k, v in S.items()}
    dt_t, sj_t = ht.dt_estimate_full(St)
    dt_j, sj_j = hj.dt_estimate_full(Sj)
    assert float(dt_t) == pytest.approx(float(dt_j), rel=1e-12)
    St, _, it_t, _ = ht.advance(St, 0.5 * float(dt_j), sJit1=sj_t)
    Sj, _, it_j, _ = hj.advance(Sj, 0.5 * float(dt_j), sJit1=sj_j)
    assert int(it_t[0]) == int(it_j[0])
    assert abs(int(it_t[1]) - int(it_j[1])) <= 2
    Sn = state_to_numpy(St)
    for k in ("x", "v", "e"):
        assert _rel(Sn[k], Sj[k]) <= 1e-12, k


def test_cli_kron_rk2avg_conserves_energy():
    """The CLI with --precond kron on the lattice path: RK2Avg drift to
    round-off, at most 3 CG iterations per component solve."""
    run = cli.main(["-d", "cpu", "-p", "1", "-dim", "3", "-rs", "1", "-s",
                    "7", "-cgt", "1e-12", "-ms", "6", "-vs", "1000",
                    "--precond", "kron"])
    h, res = run.hydro, run.result
    assert h._lat is not None and "kron" in h._lat
    drift = abs(res.energy_final - res.energy_init) / abs(res.energy_init)
    assert drift <= 1e-12
    assert res.h1_iters <= 3 * 3 * 2 * res.steps


def test_f32_lattice_run_tracks_f64():
    """An f32 run of the lattice path stays finite and close to f64."""
    runs = {}
    for dtype in (torch.float64, torch.float32):
        h = THydro(tdata.get_mesh("cube01_hex"),
                   TOptions(problem=1, ode_solver=7, cg_tol=1e-7),
                   dtype=dtype, device="cpu")
        runs[dtype] = driver.run(h, t_final=0.6, max_steps=4,
                                 vis_steps=10**6)
    e32, e64 = runs[torch.float32].e_norm, runs[torch.float64].e_norm
    assert np.isfinite(e32) and abs(e32 - e64) <= 1e-4 * e64
