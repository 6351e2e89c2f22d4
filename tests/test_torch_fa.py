"""Full assembly (-fa) and 1D in the PyTorch port, on the CPU, against the
JAX package: the element matrices and the assembled sparse mass, the 1D
setup arrays, the coupled FA velocity CG, 1D and 3D FA trajectories, and
BASELINE row 5 (p2 Sod on segment01, rs5, -fa) through the port's CLI.

The assembled H1 mass sums duplicate entries in another order than the JAX
package's BCOO.sum_duplicates, so the sparse products agree to round-off
(1e-11, as tests/test_ops.py holds the JAX FA path to its PA path), not
bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laghos_tpu import data as jdata
from laghos_tpu import driver as jdriver
from laghos_tpu.fem import mesh as jmesh
from laghos_tpu.fem import space as jspace
from laghos_tpu.hydro import Hydro as JHydro
from laghos_tpu.hydro import Options as JOptions
from laghos_tpu.ops import assemble as jassemble
from laghos_tpu.ops import force as jforce
from laghos_tpu_torch import cli, driver
from laghos_tpu_torch import data as tdata
from laghos_tpu_torch.fem import basis as tbasis
from laghos_tpu_torch.fem import mesh as tmesh
from laghos_tpu_torch.fem import space as tspace
from laghos_tpu_torch.golden import GOLDEN, NO_REF_MESH, line, run_row
from laghos_tpu_torch.hydro import Hydro as THydro
from laghos_tpu_torch.hydro import Options as TOptions
from laghos_tpu_torch.interop import hydro_arrays, state_to_numpy
from laghos_tpu_torch.ops import assemble as tassemble
from laghos_tpu_torch.ops import force as tforce
from laghos_tpu_torch.ops import mass as tmass

torch.set_num_threads(1)

MESH = {1: "segment01", 2: "square01_quad", 3: "cube01_hex"}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _meshes(dim, rs):
    mt, mj = tdata.get_mesh(MESH[dim]), jdata.get_mesh(MESH[dim])
    for _ in range(rs):
        mt, mj = tmesh.uniform_refine(mt), jmesh.uniform_refine(mj)
    return mt, mj


@pytest.mark.parametrize("dim", [2, 3])
def test_fa_operators_match_jax_and_pa(dim):
    """The port's force applies (partially assembled under -fa, as in both
    packages' Hydro) against the JAX package's element force matrices and
    their applies, at 1e-11; the element mass matrices and the assembled
    CSR mass product against the JAX package's assemble functions, its
    BCOO product and the port's own PA apply, at 1e-11."""
    mt, _ = _meshes(dim, 1)
    sp = tspace.build_h1_space(mt, 2)
    h1 = tbasis.h1_gl_basis(2, 4)
    l2 = tbasis.l2_bernstein_basis(1, 4)
    NE, NQ, nd = mt.num_elems, 4**dim, 3**dim
    rng = np.random.default_rng(dim)
    D = rng.uniform(0.5, 1.5, (NE, NQ))
    sJ = rng.normal(size=(NE, NQ, dim, dim))
    e = rng.normal(size=(NE, 2**dim))
    v_e = rng.normal(size=(NE, dim, nd))
    u = rng.normal(size=(dim, sp.ndof))
    tt = {"H1B": torch.tensor(h1.B), "H1G": torch.tensor(h1.G),
          "L2B": torch.tensor(l2.B)}
    tj = {k: jnp.asarray(v.numpy()) for k, v in tt.items()}

    F_j = jassemble.force_element_matrices(jnp.asarray(sJ), tj, dim=dim)
    fe_j = np.asarray(jassemble.force_apply_fa(F_j, jnp.asarray(e)))
    pa = tforce.force_mult(torch.tensor(e), torch.tensor(sJ), tt, dim=dim,
                           ftz_eps2=0.0)
    assert _rel(fe_j.transpose(0, 2, 1), pa.numpy()) <= 1e-11
    ft_j = jassemble.force_apply_transpose_fa(F_j, jnp.asarray(v_e))
    pa_t = tforce.force_mult_transpose(torch.tensor(v_e), torch.tensor(sJ),
                                       tt, dim=dim)
    assert _rel(ft_j, pa_t.numpy()) <= 1e-11
    assert _rel(pa_t.numpy(), jforce.force_mult_transpose(
        jnp.asarray(v_e), jnp.asarray(sJ), tj, dim=dim)) <= 1e-13

    M_t = tassemble.h1_mass_element_matrices(torch.tensor(D), tt["H1B"], dim)
    M_j = jassemble.h1_mass_element_matrices(jnp.asarray(D), tj["H1B"], dim)
    assert _rel(M_t.numpy(), M_j) <= 1e-13
    A = tassemble.to_csr(M_t.numpy(), sp.gather, sp.ndof)
    assert A.crow_indices().dtype == torch.int32
    assert A.col_indices().dtype == torch.int32
    y = tassemble.csr_apply(A, torch.tensor(u)).numpy()
    y_bcoo = np.asarray((jassemble.to_bcoo(M_j, sp.gather, sp.ndof)
                         @ jnp.asarray(u).T).T)
    assert _rel(y, y_bcoo) <= 1e-11
    y_pa = tmass.h1_mass_apply(torch.tensor(u), torch.as_tensor(
        sp.gather, dtype=torch.long), sp.ndof, torch.tensor(D), tt["H1B"],
        dim).numpy()
    assert _rel(y, y_pa) <= 1e-11
    # the CSR holds each coupled pair once: nnz of the element coupling
    pairs = {(int(a), int(b)) for g in sp.gather for a in g for b in g}
    assert A.values().numel() == len(pairs)


@pytest.mark.parametrize("p", [2, 3])
def test_1d_setup_bitwise(p):
    """1D Cartesian mesh, refinement, gather map, node coordinates and
    essential masks are the JAX package's bit for bit; so are the static
    arrays of a 1D Hydro (FA: the reference has no PA in 1D)."""
    mt, mj = _meshes(1, 3)
    for name in ("verts", "elems", "bdr_verts", "bdr_attr"):
        np.testing.assert_array_equal(getattr(mt, name), getattr(mj, name))
    c_t = tmesh.cartesian(1, (5,), (2.0,))
    c_j = jmesh.cartesian(1, (5,), (2.0,))
    np.testing.assert_array_equal(c_t.verts, c_j.verts)
    np.testing.assert_array_equal(c_t.bdr_verts, c_j.bdr_verts)
    st, sj = tspace.build_h1_space(mt, p), jspace.build_h1_space(mj, p)
    np.testing.assert_array_equal(st.gather, sj.gather)
    np.testing.assert_array_equal(st.node_coords, sj.node_coords)
    np.testing.assert_array_equal(st.ess_mask(0), sj.ess_mask(0))

    ht = THydro(mt, TOptions(problem=2, order_v=p, order_e=p - 1),
                device="cpu")
    hj = JHydro(mj, JOptions(problem=2, order_v=p, order_e=p - 1))
    assert not ht.p_assembly and not hj.p_assembly
    assert (ht._sm is not None) == (hj._sm is not None)
    a = hydro_arrays(ht)
    np.testing.assert_array_equal(a["gather"], np.asarray(hj.gather))
    np.testing.assert_array_equal(a["ess_mask"], hj.ess_mask)
    # at Q3 the t=0 Jacobian rounds differently in XLA's CPU dot and
    # torch's BLAS, as in 2D/3D (tests/test_torch_setup.py)
    tol = 1e-15 if p == 2 else 2e-14
    assert ht.h0 == pytest.approx(hj.h0, rel=tol)
    for name in ("massD", "rho0DetJ0w", "Jac0inv", "h1_dinv"):
        assert _rel(a[name], getattr(hj, name)) <= tol, name
    for k, v in a["S0"].items():
        assert _rel(v, hj.S0[k]) <= tol, k
    assert _rel(ht.Me_inv.numpy(), hj.Me_inv) <= 10 * tol


def test_1d_fa_trajectory_matches_jax():
    """The first 27 step attempts of BASELINE row 5's configuration (p2
    Sod, segment01 rs5, FA, RK4; six of them rejected and repeated) in
    both packages: 21 accepted steps, states at 1e-12, CG counts equal."""
    mt, mj = _meshes(1, 5)
    ht = THydro(mt, TOptions(problem=2, p_assembly=False), device="cpu")
    hj = JHydro(mj, JOptions(problem=2, p_assembly=False))
    rt = driver.run(ht, t_final=0.2, max_steps=26, vis_steps=10**6)
    rj = jdriver.run(hj, t_final=0.2, max_steps=26, vis_steps=10**6)
    assert rt.steps == rj.steps == 21
    assert (rt.h1_iters, rt.l2_iters) == (rj.h1_iters, rj.l2_iters)
    assert rt.t == pytest.approx(rj.t, rel=1e-14)
    Sn = state_to_numpy(rt.S)
    for k in ("x", "v", "e"):
        assert _rel(Sn[k], rj.S[k]) <= 1e-12, k


@pytest.mark.parametrize("dim", [2, 3])
def test_fa_coupled_cg_matches_jax(dim):
    """The coupled FA velocity CG (one residual over all d*ndof unknowns,
    Jacobi with ones at the essential dofs) against the JAX package's
    `_cg_velocity` on the same right-hand side: solutions at 1e-9, the
    iteration count equal (the stopping test at -cgt 1e-10 sits well above
    round-off; at 1e-14 torch and XLA can differ by one, ROADMAP C2)."""
    mt, mj = _meshes(dim, 1)
    ht = THydro(mt, TOptions(problem=1, p_assembly=False, cg_tol=1e-10),
                device="cpu")
    hj = JHydro(mj, JOptions(problem=1, p_assembly=False, cg_tol=1e-10))
    assert ht._h1_csr is not None and hj._h1_bcoo is not None
    rng = np.random.default_rng(dim)
    b = np.where(ht.ess_mask, 0.0, rng.normal(size=(dim, ht.ndof)))
    x_t, it_t = ht._cg_velocity(torch.tensor(b))
    x_j, it_j = hj._jcg_v(jnp.asarray(b))
    assert int(it_t) == int(it_j)
    assert _rel(x_t.numpy(), x_j) <= 1e-9
    # against the PA path's per-component CG
    x_pa, _ = THydro(mt, TOptions(problem=1, cg_tol=1e-10,
                                  precond="jacobi"),
                     device="cpu")._cg_velocity(torch.tensor(b))
    assert _rel(x_t.numpy(), x_pa.numpy()) <= 1e-8


def test_fa_3d_run_matches_pa():
    """3D Sedov at rs1 through the CLI with -fa against -pa (the lattice
    path), RK2Avg, 10 steps: |e| and the states at 1e-10; the FA run
    conserves energy as well."""
    argv = ["-d", "cpu", "-p", "1", "-dim", "3", "-rs", "1", "-s", "7",
            "-cgt", "1e-12", "-ms", "9", "-vs", "100"]
    fa = cli.main(argv + ["-fa"])
    pa = cli.main(argv)
    assert not fa.hydro.p_assembly and fa.hydro._lat is None
    assert pa.hydro._lat is not None
    rf, rp = fa.result, pa.result
    assert rf.steps == rp.steps == 10
    assert abs(rf.e_norm - rp.e_norm) / rp.e_norm <= 1e-10
    for k in ("x", "v", "e"):
        assert _rel(rf.S[k].numpy(), rp.S[k].numpy()) <= 1e-10, k
    drift = abs(rf.energy_final - rf.energy_init) / abs(rf.energy_init)
    assert drift <= 1e-12


def test_baseline_row5_through_cli():
    """BASELINE row 5 as written, `-p 2 -m segment01 -rs 5 -tf 0.2 -fa`,
    through the port's CLI on the CPU: 413 steps, printed dt 0.000470,
    |e| within 1e-9 of 3.2012077410e+01."""
    r = run_row(5, device="cpu")
    assert r["ok"], line(r)
    assert r["run"].hydro.dim == 1 and not r["run"].hydro.p_assembly


def _row7_hydros(**opt):
    """Both packages' Hydro for BASELINE row 7's command line, `-p 3 -m
    box01_hex -rs 1 -pa` (Q2-Q1, the CLIs' Jacobi), on the built-in
    box01_hex, with `opt` on top: the lattice path in both."""
    mt, mj = tdata.get_mesh("box01_hex"), jdata.get_mesh("box01_hex")
    mt, mj = tmesh.uniform_refine(mt), jmesh.uniform_refine(mj)
    opt = dict(problem=3, precond="jacobi", **opt)
    ht = THydro(mt, TOptions(**opt), device="cpu")
    hj = JHydro(mj, JOptions(**opt))
    assert ht._lat is not None
    return ht, hj


def test_row7_builtin_mesh_prefix_matches_jax():
    """BASELINE row 7 has no reference mesh in the repository (its
    built-in box01_hex stands in for the reference's box file, so
    golden.py holds it to nothing).  Its first 50 step attempts in both
    packages (40 accepted, ten rejected and repeated) at -cgt 1e-10:
    steps, t and L2 CG counts equal, states at 1e-12.  The H1 CG totals
    may differ by one, where a solve's stopping test ties at round-off
    (ROADMAP C2).  At the row's own -cgt 1e-8 the states agree only above
    1e-11: an iterate stopped early carries the round-off of its
    recurrence."""
    assert NO_REF_MESH == {7}
    ht, hj = _row7_hydros(cg_tol=1e-10)
    rt = driver.run(ht, t_final=5.0, max_steps=49, vis_steps=10**6)
    rj = jdriver.run(hj, t_final=5.0, max_steps=49, vis_steps=10**6)
    assert rt.steps == rj.steps == 40
    assert rt.l2_iters == rj.l2_iters
    assert abs(rt.h1_iters - rj.h1_iters) <= 1
    assert rt.t == pytest.approx(rj.t, rel=1e-14)
    Sn = state_to_numpy(rt.S)
    for k in ("x", "v", "e"):
        assert _rel(Sn[k], rj.S[k]) <= 1e-12, k


@pytest.mark.slow
@pytest.mark.parametrize("row", sorted(GOLDEN))
def test_golden_rows_cpu(row):
    """All nine BASELINE rows through `laghos_tpu_torch.golden` on the
    CPU (minutes each).  Row 7, without its reference mesh, against the
    JAX package's run of the same command on the same built-in mesh: step
    count and printed dt equal, |e| at 1e-9."""
    r = run_row(row, device="cpu")
    if row not in NO_REF_MESH:
        assert r["ok"], line(r)
        return
    assert r["ok"] is None, line(r)
    rj = jdriver.run(_row7_hydros()[1], t_final=5.0, vis_steps=100)
    assert r["steps"] == rj.steps, line(r)
    assert f"{r['dt']:.6f}" == f"{rj.dt:.6f}", line(r)
    assert abs(r["e_norm"] - rj.e_norm) / rj.e_norm < 1e-9, line(r)
