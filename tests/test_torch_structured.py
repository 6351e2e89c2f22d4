"""Structure detection, raster renumbering and the parity E<->L transforms
of the PyTorch port (`laghos_tpu_torch/ops/structured.py`) against the JAX
package, on the CPU, and the fall-back to the gather path off raster
meshes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laghos_tpu import data as jdata
from laghos_tpu.fem import mesh as jmesh
from laghos_tpu.fem import space as jspace
from laghos_tpu.hydro import Hydro as JHydro
from laghos_tpu.hydro import Options as JOptions
from laghos_tpu.ops import structured as jstruct
from laghos_tpu_torch import data as tdata
from laghos_tpu_torch.fem import mesh as tmesh
from laghos_tpu_torch.fem import space as tspace
from laghos_tpu_torch.hydro import Hydro as THydro
from laghos_tpu_torch.hydro import Options as TOptions
from laghos_tpu_torch.interop import (hydro_arrays, state_from_numpy,
                                      state_to_numpy)
from laghos_tpu_torch.ops import mass as tmass
from laghos_tpu_torch.ops import structured as tstruct

torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _meshes(name, rs):
    mt, mj = tdata.get_mesh(name), jdata.get_mesh(name)
    for _ in range(rs):
        mt, mj = tmesh.uniform_refine(mt), jmesh.uniform_refine(mj)
    return mt, mj


@pytest.mark.parametrize("d,n,p", [
    (2, (3, 2), 2), (2, (4, 4), 1), (3, (2, 3, 2), 2), (3, (3, 3, 3), 3),
    (3, (2, 2, 2), 4)])
def test_struct_transforms_match_gather_and_jax(d, n, p):
    """l_to_e_struct is the gather bit for bit; e_to_l_struct is the
    assembly (sums of at most 2^d terms, in another order than the
    scatter-add, so to round-off); both as the JAX package's."""
    rng = np.random.default_rng(0)
    mt = tmesh.cartesian(d, n, (1.0,) * d)
    mj = jmesh.cartesian(d, n, (1.0,) * d)
    st, sj = tspace.build_h1_space(mt, p), jspace.build_h1_space(mj, p)
    smt = tstruct.detect_structure(mt, st.gather, p)
    smj = jstruct.detect_structure(mj, sj.gather, p)
    assert smt is not None
    for f in ("perm", "inv", "e_mesh_at_raster", "e_raster_at_mesh"):
        np.testing.assert_array_equal(getattr(smt, f), getattr(smj, f))
    u = rng.normal(size=(2, st.ndof))
    g = torch.as_tensor(st.gather, dtype=torch.long)
    ue = tstruct.l_to_e_struct(_t(u), smt)
    assert torch.equal(ue, tmass.l_to_e(_t(u), g))
    np.testing.assert_array_equal(
        ue.numpy(), np.asarray(jstruct.l_to_e_struct(jnp.asarray(u), smj)))
    ve = rng.normal(size=(2, mt.num_elems, (p + 1) ** d))
    got = tstruct.e_to_l_struct(_t(ve), smt).numpy()
    assert _rel(got, tmass.e_to_l(_t(ve), st.gather, st.ndof).numpy()) \
        <= 1e-15
    assert _rel(got, jstruct.e_to_l_struct(jnp.asarray(ve), smj)) <= 1e-15


@pytest.mark.parametrize("name,rs", [("cube01_hex", 0), ("cube01_hex", 1),
                                     ("box01_hex", 0), ("box01_hex", 1),
                                     ("square01_quad", 1),
                                     ("rectangle01_quad", 0)])
def test_raster_maps_and_renumbering_match_jax(name, rs):
    """The default Hydro of both packages on a Cartesian mesh: raster
    element order, structure maps, the renumbered gather map, node
    coordinates and essential masks bit for bit; the static arrays built
    on them (t=0 data, Jacobi diagonal, S0) as in the gather path."""
    mt, mj = _meshes(name, rs)
    ht = THydro(mt, TOptions(problem=1), device="cpu")
    hj = JHydro(mj, JOptions(problem=1))
    assert ht._sm is not None and hj._sm is not None
    np.testing.assert_array_equal(ht.mesh.elems, hj.mesh.elems)
    assert ht._sm.dims == hj._sm.dims and ht._sm.p == hj._sm.p
    for f in ("perm", "inv", "e_mesh_at_raster", "e_raster_at_mesh"):
        np.testing.assert_array_equal(getattr(ht._sm, f),
                                      getattr(hj._sm, f))
    assert ht._sm.identity_perm
    np.testing.assert_array_equal(ht.h1.gather, hj.h1.gather)
    np.testing.assert_array_equal(ht.h1.node_coords, hj.h1.node_coords)
    np.testing.assert_array_equal(ht.ess_mask, hj.ess_mask)
    assert ht._inc is None                    # no incidence table needed
    a = hydro_arrays(ht)
    for k in ("massD", "rho0DetJ0w", "Jac0inv", "h1_dinv"):
        assert _rel(a[k], getattr(hj, k)) <= 1e-15, k
    for k, v in a["S0"].items():
        assert _rel(v, hj.S0[k]) <= 1e-15, k


def _perturbed(dim):
    """A 4^dim Cartesian mesh with its interior vertices moved: still
    conforming, no longer a raster lattice."""
    mt = tmesh.uniform_refine(tdata.get_mesh({2: "square01_quad",
                                              3: "cube01_hex"}[dim]))
    mj = jmesh.uniform_refine(jdata.get_mesh({2: "square01_quad",
                                              3: "cube01_hex"}[dim]))
    v = mt.verts
    interior = np.all((v > 1e-12) & (v < 1.0 - 1e-12), axis=1)
    rng = np.random.default_rng(4)
    shift = np.where(interior[:, None], 0.03 * rng.normal(size=v.shape), 0.0)
    mt.verts = v + shift
    mj.verts = np.asarray(mj.verts) + shift
    return mt, mj


@pytest.mark.parametrize("dim", [2, 3])
def test_fallback_to_gather_path_off_raster(dim):
    """Perturbed interior vertices: no structure, no lattice, Jacobi PCG
    and the incidence assembly, in both packages; one memoized step of
    the default Hydro agrees with JAX's."""
    mt, mj = _perturbed(dim)
    assert tstruct.reorder_mesh_elements_to_raster(mt) is None
    ht = THydro(mt, TOptions(problem=1, cg_tol=1e-14), device="cpu")
    hj = JHydro(mj, JOptions(problem=1, cg_tol=1e-14))
    assert ht._sm is None and ht._lat is None and ht._inc is not None
    assert hj._sm is None and hj._lat is None
    np.testing.assert_array_equal(ht.h1.gather, hj.h1.gather)
    S = {k: np.asarray(v) for k, v in hj.S0.items()}
    St, Sj = state_from_numpy(S), {k: jnp.asarray(v) for k, v in S.items()}
    dt_t, sj_t = ht.dt_estimate_full(St)
    dt_j, sj_j = hj.dt_estimate_full(Sj)
    dt = 0.5 * float(dt_j)
    St, est_t, it_t, _ = ht.advance(St, dt, sJit1=sj_t)
    Sj, est_j, it_j, _ = hj.advance(Sj, dt, sJit1=sj_j)
    assert tuple(int(i) for i in it_t) == tuple(int(i) for i in it_j)
    Sn = state_to_numpy(St)
    for k in ("x", "v", "e"):
        assert _rel(Sn[k], Sj[k]) <= 1e-12, k


@pytest.mark.parametrize("dim", [2, 3])
def test_structured_without_lattice_matches_jax(dim):
    """structured_el=True, lattice_ops=False: the gather path with the
    parity transforms for gather and assembly, against the same JAX
    configuration (q-update, mass apply, one step)."""
    name = {2: "rectangle01_quad", 3: "box01_hex"}[dim]
    mt, mj = _meshes(name, 1 if dim == 2 else 0)
    opt = dict(problem=1, cg_tol=1e-14, lattice_ops=False)
    ht = THydro(mt, TOptions(**opt), device="cpu")
    hj = JHydro(mj, JOptions(**opt))
    assert ht._sm is not None and ht._lat is None and ht._inc is None
    rng = np.random.default_rng(2)
    S0 = {k: np.asarray(v) for k, v in hj.S0.items()}
    S = {"x": S0["x"] + 0.005 * rng.normal(size=S0["x"].shape),
         "v": np.where(ht.ess_mask, 0.0, 0.1 * rng.normal(
             size=S0["v"].shape)),
         "e": S0["e"] + 0.5}
    St, Sj = state_from_numpy(S), {k: jnp.asarray(v) for k, v in S.items()}
    s_t, d_t = ht._qupdate(St)
    s_j, d_j = jax.jit(hj._qupdate)(Sj)
    s_j = np.stack(s_j) if dim == 3 else np.asarray(s_j)
    assert _rel(s_t.numpy(), s_j) <= 1e-13
    assert float(d_t) == pytest.approx(float(d_j), rel=1e-13)
    u = rng.normal(size=(dim, ht.ndof))
    assert _rel(ht._h1_apply_bc(_t(u)).numpy(),
                jax.jit(hj._h1_apply_bc)(jnp.asarray(u))) <= 1e-14
    dt = 0.5 * float(d_j)
    St, _, it_t, _ = ht.advance(St, dt)
    Sj, _, it_j, _ = hj.advance(Sj, dt)
    assert tuple(int(i) for i in it_t) == tuple(int(i) for i in it_j)
    Sn = state_to_numpy(St)
    for k in ("x", "v", "e"):
        assert _rel(Sn[k], Sj[k]) <= 1e-12, k
