"""Host setup of the PyTorch port against the JAX package: quadrature,
basis tables, meshes, the H1 gather map, essential masks and the static
arrays of `Hydro`."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from laghos_tpu import data as jdata
from laghos_tpu.fem import basis as jbasis
from laghos_tpu.fem import mesh as jmesh
from laghos_tpu.fem import quadrature as jquad
from laghos_tpu.fem import space as jspace
from laghos_tpu.hydro import Hydro as JHydro
from laghos_tpu.hydro import Options as JOptions
from laghos_tpu_torch import data as tdata
from laghos_tpu_torch.fem import basis as tbasis
from laghos_tpu_torch.fem import mesh as tmesh
from laghos_tpu_torch.fem import quadrature as tquad
from laghos_tpu_torch.fem import space as tspace
from laghos_tpu_torch.hydro import Hydro as THydro
from laghos_tpu_torch.hydro import Options as TOptions
from laghos_tpu_torch.interop import hydro_arrays

torch.set_num_threads(1)

MESH = {2: "square01_quad", 3: "cube01_hex"}


@pytest.mark.parametrize("n", [2, 3, 4, 5, 7, 9])
def test_quadrature_bitwise(n):
    xj, wj = jquad.gauss_legendre(n)
    xt, wt = tquad.gauss_legendre(n)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(wt, wj)
    np.testing.assert_array_equal(tquad.gauss_lobatto(n),
                                  jquad.gauss_lobatto(n))


@pytest.mark.parametrize("ok,ot", [(2, 1), (3, 2), (4, 3)])
def test_basis_tables_bitwise(ok, ot):
    nq = tquad.points_for_order(tquad.default_rule_order(ok, ot))
    for jb, tb in ((jbasis.h1_gl_basis(ok, nq), tbasis.h1_gl_basis(ok, nq)),
                   (jbasis.l2_bernstein_basis(ot, nq),
                    tbasis.l2_bernstein_basis(ot, nq))):
        np.testing.assert_array_equal(tb.B, jb.B)
        np.testing.assert_array_equal(tb.G, jb.G)
    np.testing.assert_array_equal(tbasis.nodal_to_bernstein(ot),
                                  jbasis.nodal_to_bernstein(ot))


def _assert_mesh_equal(mt, mj):
    assert mt.dim == mj.dim
    for name in ("verts", "elems", "bdr_verts", "bdr_attr"):
        np.testing.assert_array_equal(getattr(mt, name), getattr(mj, name))


@pytest.mark.parametrize("name", ["square01_quad", "cube01_hex",
                                  "rectangle01_quad", "box01_hex",
                                  "square_gresho", "rt2D"])
def test_mesh_refine_bitwise(name):
    mt, mj = tdata.get_mesh(name), jdata.get_mesh(name)
    _assert_mesh_equal(mt, mj)
    _assert_mesh_equal(tmesh.uniform_refine(mt), jmesh.uniform_refine(mj))


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("p", [2, 3])
def test_gather_and_masks_bitwise(dim, p):
    mt = tmesh.uniform_refine(tdata.get_mesh(MESH[dim]))
    mj = jmesh.uniform_refine(jdata.get_mesh(MESH[dim]))
    st, sj = tspace.build_h1_space(mt, p), jspace.build_h1_space(mj, p)
    assert st.ndof == sj.ndof
    np.testing.assert_array_equal(st.gather, sj.gather)
    np.testing.assert_array_equal(st.node_coords, sj.node_coords)
    for c in range(dim):
        np.testing.assert_array_equal(st.ess_mask(c), sj.ess_mask(c))


@pytest.mark.parametrize("name,p", [("box01_hex", 2), ("rt2D", 3),
                                    ("square_gresho", 4),
                                    ("rectangle01_quad", 8)])
def test_gather_and_masks_bitwise_other_meshes(name, p):
    """The gather map and the essential masks (the boundary attributes of
    each dof) on meshes with other boundary attributes and orders."""
    mt, mj = tdata.get_mesh(name), jdata.get_mesh(name)
    st, sj = tspace.build_h1_space(mt, p), jspace.build_h1_space(mj, p)
    assert st.ndof == sj.ndof
    np.testing.assert_array_equal(st.gather, sj.gather)
    for c in range(mt.dim):
        np.testing.assert_array_equal(st.ess_mask(c), sj.ess_mask(c))


@pytest.mark.parametrize("shape,lo,hi", [((3000, 16), -1, 6),
                                         ((2000, 3), -2**62, 2**62),
                                         ((800, 4), -2**63, 2**63 - 1),
                                         ((1500, 70), 0, 2)])
def test_unify_rows_is_the_sorted_unique(shape, lo, hi):
    """unify_rows against np.unique(axis=0): the same ids in row order and
    first occurrences, packed columns or not (wide ranges stay as they
    are)."""
    rng = np.random.default_rng(0)
    keys = rng.integers(lo, hi, size=shape, dtype=np.int64)
    keys = np.concatenate([keys, keys[::3]])
    n, inverse, first = tmesh.unify_rows(keys)
    uniq, ref_first, ref_inverse = np.unique(keys, axis=0,
                                             return_index=True,
                                             return_inverse=True)
    assert n == uniq.shape[0]
    np.testing.assert_array_equal(inverse, ref_inverse.reshape(-1))
    np.testing.assert_array_equal(first, ref_first)


@pytest.mark.parametrize("nq,n", [(4096, 512), (729, 216), (64, 8)])
def test_weighted_gram_bitwise_one_einsum(nq, n):
    """The threaded Gram of the Sedov delta's normalization: the bits of
    one np.einsum call."""
    from laghos_tpu_torch.hydro import _weighted_gram

    rng = np.random.default_rng(1)
    B, w = rng.normal(size=(nq, n)), rng.normal(size=nq)
    np.testing.assert_array_equal(_weighted_gram(B, w),
                                  np.einsum("qi,qj,q->ij", B, B, w))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_det_inv_bitwise_numpy(dtype):
    """The t=0 Jacobians' determinants and inverses over worker processes
    (a batch above MIN_WORKER_BATCH): numpy's bits, in J's precision, and
    numpy's LinAlgError on a singular matrix."""
    from laghos_tpu_torch.fem import batched_la

    rng = np.random.default_rng(2)
    n = batched_la.MIN_WORKER_BATCH + 12345
    J = (rng.normal(size=(5, n // 5, 3, 3)) + 2 * np.eye(3)).astype(dtype)
    det, inv = batched_la.det_inv(J)
    want = J
    assert det.dtype == inv.dtype == dtype
    np.testing.assert_array_equal(det, np.linalg.det(want))
    np.testing.assert_array_equal(inv, np.linalg.inv(want))
    J[2, 7] = 0.0
    with pytest.raises(np.linalg.LinAlgError):
        batched_la.det_inv(J)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("ok,ot", [(2, 1), (3, 2)])
def test_hydro_arrays_match(dim, ok, ot):
    mt = tmesh.uniform_refine(tdata.get_mesh(MESH[dim]))
    mj = jmesh.uniform_refine(jdata.get_mesh(MESH[dim]))
    ht = THydro(mt, TOptions(problem=1, order_v=ok, order_e=ot,
                             structured_el=False, lattice_ops=False,
                             precond="jacobi"), device="cpu")
    hj = JHydro(mj, JOptions(problem=1, order_v=ok, order_e=ot,
                             structured_el=False, lattice_ops=False,
                             precond="jacobi"))
    a = hydro_arrays(ht)
    np.testing.assert_array_equal(a["gather"], np.asarray(hj.gather))
    np.testing.assert_array_equal(a["ess_mask"], hj.ess_mask)
    assert ht.h0 == pytest.approx(hj.h0, rel=1e-15)
    # Q2-Q1 (the main path) agrees to an ulp or two.  At Q3 the t=0
    # Jacobian sums H1G terms with cancellation (|G| ~ 6 against J ~ 0.25)
    # and XLA's CPU dot orders that sum differently from torch's BLAS:
    # J0 differs by up to ~1.4e-15 absolute, and detJ0, inv(J0) and all
    # arrays built on them by up to ~1.1e-14 relative.
    tol = 1e-15 if (ok, ot) == (2, 1) else 2e-14
    for name in ("massD", "rho0DetJ0w", "Jac0inv", "h1_dinv"):
        assert _rel(a[name], getattr(hj, name)) <= tol, name
    for k, v in a["tables"].items():
        np.testing.assert_array_equal(v, np.asarray(hj.tables[k]))
    for k, v in a["S0"].items():
        assert _rel(v, hj.S0[k]) <= tol, k


def test_port_imports_no_jax():
    """The port package and chip_smoke.py import neither jax nor
    laghos_tpu."""
    root = pathlib.Path(__file__).resolve().parent.parent
    paths = list((root / "laghos_tpu_torch").rglob("*.py"))
    paths.append(root / "chip_smoke.py")
    names = {p.name for p in paths}
    assert {"omm.py", "assemble.py", "golden.py", "sedov_tool.py", "io.py",
            "vis.py", "checkpoint.py", "sedov.py"} <= names
    # the distributed modules (parallel/)
    assert {"comm.py", "partition.py", "scaling.py", "halo.py", "view.py",
            "slab_hydro.py", "chunk_hydro.py", "sharding.py", "segment.py",
            "runs.py", "probes.py"} <= names
    bad = []
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "laghos_tpu")]
    assert not bad, bad


def test_sass_instructions_counts_each_kernel(monkeypatch, tmp_path):
    """`kernels.sass_instructions` reads cuobjdump's listing: instructions
    per kernel, predicated ones included, NOPs and headers left out."""
    from laghos_tpu_torch.ops import kernels

    name = ("_ZN40_GLOBAL__N__b1d8e411_8_qphys_cu_9b1f917612qphys_kernelIdLi1"
            "ELb1ELb0EEEvNS_4ArgsIT_EE")
    listing = f"""
	code for sm_90a
		Function : {name}
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;            /* 0x00000a00ff017b82 */
        /*0010*/                   MUFU.RCP R3, R2 ;                 /* 0x0000000200037308 */
        /*0020*/              @!P0 CALL.REL.NOINC 0x1230 ;          /* 0x0000001000008944 */
        /*0030*/                   DFMA R4, R2, R4, R6 ;             /* 0x000000040204722b */
        /*0040*/                   NOP ;                             /* 0x0000000000007918 */
		Function : _ZN12_GLOBAL__N_112split_kernelILi8EEEvPKdPaPdlilii
        /*0000*/                   EXIT ;                            /* 0x000000000000794d */
"""
    seen = []

    def run(cmd, **kw):
        seen.append(cmd)
        return type("Done", (), {"stdout": listing})

    monkeypatch.setattr(kernels.subprocess, "run", run)
    monkeypatch.setattr(kernels, "_nvcc", lambda: "/usr/local/cuda/bin/nvcc")
    got = kernels.sass_instructions(tmp_path / "lib.so")
    assert got == {name: 4,
                   "_ZN12_GLOBAL__N_112split_kernelILi8EEEvPKdPaPdlilii": 1}
    assert seen[0][:2] == ["/usr/local/cuda/bin/cuobjdump", "-sass"]
