"""Full assembly: the velocity mass as one global sparse matrix.

The reference's full-assembly (-fa) path assembles the velocity mass once
as a global matrix (laghos_solver.cpp:201-221, 413-439).  The counterpart
of the mass half of `laghos_tpu.ops.assemble`: dense element mass matrices
of the scalar H1 space from the t=0 quadrature data, coalesced once on the
host into a CSR matrix.  The force stays partially assembled under -fa, as
in the JAX package's Hydro (tests/test_torch_fa.py holds the port's force
to the JAX package's element force matrices).

The CSR matrix is coalesced in NumPy in a fixed order (entries sorted by
(row, column), duplicates summed in element order) and held on the device
as a torch sparse CSR tensor with int32 indices.  Its product with the d
velocity components (`csr_apply`) is a library call, as the JAX package's
BCOO product is (no Pallas kernel computes it either): one sparse
matrix-vector product (cuSPARSE SpMV) per component, not one
sparse-times-dense product (SpMM) with the (ndof, d) block.  On the H100,
on the 3D Sedov rs4 mass (16,974,593 nonzeros; chip_smoke.py phase 8), 0
of 50 SpMM applies repeated the first bit for bit and one SpMM took 3.3x
as long as the d SpMVs, which repeated in 50 of 50.  cuSPARSE documents
no such guarantee for SpMV: its repeatability is observed at the sizes
tried, and guarded by chip_smoke.py phases 6 (a whole -fa run twice, bit
for bit) and 8, and by tests/test_torch_kernels.py::
test_csr_apply_on_card_matches_cpu_and_repeats.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch


def _full_table(B, dim):
    """(NQ, n^dim) tensor-product table of the 1D table B (npts, n), x
    fastest on both axes: kron(B_z, kron(B_y, B_x))."""
    full = B
    for _ in range(dim - 1):
        full = torch.kron(B, full)
    return full


def h1_mass_element_matrices(D, B, dim):
    """Dense element mass matrices of the scalar H1 space,
    M_e[i,j] = sum_q phi_i(q) phi_j(q) D(e,q): (NE, nd, nd)."""
    full = _full_table(B, dim)
    return torch.einsum("qi,qj,eq->eij", full, full, D)


def to_csr(elem_mats, gather, ndof, device="cpu"):
    """Assemble element matrices (NE, nd, nd) over the gather map (NE, nd)
    into a global (ndof, ndof) CSR matrix on `device`, its values in the
    element matrices' dtype.

    The coalescing runs once, on the host: entries are sorted stably by
    (row, column) and duplicates summed in element order, so the values
    do not depend on the device.  Indices are int32."""
    M = np.asarray(elem_mats)
    g = np.asarray(gather, dtype=np.int64)
    rows = np.broadcast_to(g[:, :, None], M.shape).reshape(-1)
    cols = np.broadcast_to(g[:, None, :], M.shape).reshape(-1)
    key = rows * ndof + cols
    order = np.argsort(key, kind="stable")
    key = key[order]
    start = np.flatnonzero(np.concatenate([[True], key[1:] != key[:-1]]))
    vals = np.add.reduceat(M.reshape(-1)[order], start)
    r, c = np.divmod(key[start], ndof)
    crow = np.zeros(ndof + 1, dtype=np.int64)
    np.cumsum(np.bincount(r, minlength=ndof), out=crow[1:])
    if crow[-1] >= 2**31:
        raise ValueError(f"{crow[-1]} nonzeros do not fit int32 indices")
    with warnings.catch_warnings():
        # torch's notes that sparse CSR is in beta and that invariant
        # checks are off unless asked: they are asked for here
        warnings.filterwarnings("ignore", "Sparse CSR tensor support")
        warnings.filterwarnings("ignore", "Sparse invariant checks")
        A = torch.sparse_csr_tensor(
            torch.as_tensor(crow, dtype=torch.int32),
            torch.as_tensor(c, dtype=torch.int32),
            torch.as_tensor(vals), size=(ndof, ndof), check_invariants=True)
        return A.to(device)


def csr_apply(A, u):
    """A . u for each of the rows of u (C, ndof), one sparse matrix-vector
    product each (see the module note on repeatability); returns
    (C, ndof)."""
    return torch.stack([A @ u[c] for c in range(u.shape[0])])
