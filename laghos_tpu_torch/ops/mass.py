"""Partial-assembly mass operators (velocity H1 / energy L2) + diagonals.

MFEM's PA MassIntegrator as used by the reference's MassPAOperator
(laghos_assembly.cpp:80-121): the mass matrices are constant in time by
pointwise mass conservation, with per-point data
    D(q) = w_q rho0(x_q(0)) detJ0(q)
so each apply is B^T (D . (B u)) batched over elements, plus the gather and
assembly of the continuous H1 space.  The element apply runs the CUDA
kernel `csrc/mass.cu` for CUDA tensors (`mass_apply_e`) and its plain twin
`mass_apply_e_plain` for CPU tensors.

Assembly on the step path goes through the incidence table
(`build_incidence` + `e_to_l_gather`): a gather and a fixed-order sum, so
results are bitwise repeatable on the card (a scatter-add with atomics
would not be).  The scatter-add `e_to_l` serves only one-time setup on the
host.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import kernels, tensor


def l_to_e(u_l, gather):
    """L-vector (..., ndof) -> E-vector (..., NE, nd) gather."""
    return u_l[..., gather]


def e_to_l(u_e, gather, ndof):
    """E-vector scatter-add (transpose of l_to_e), for host-side setup
    only: (..., NE, nd) CPU tensor -> (..., ndof)."""
    if u_e.device.type != "cpu":
        raise ValueError("e_to_l is the host setup path; on the device "
                         "assemble with e_to_l_gather")
    lead = u_e.shape[:-2]
    flat = u_e.reshape(lead + (-1,))
    out = torch.zeros(lead + (ndof,), dtype=u_e.dtype, device=u_e.device)
    idx = torch.as_tensor(np.asarray(gather).reshape(-1), dtype=torch.long)
    return out.index_add_(out.dim() - 1, idx, flat)


def build_incidence(gather, ndof):
    """Transpose of the gather map as a padded incidence table.

    For each global dof: the flat E-vector positions contributing to it
    (padded with position 0 and mask 0).
    Returns (incidence (ndof, V) int32, mask (ndof, V) float64), NumPy.
    """
    g = np.asarray(gather).reshape(-1)
    order = np.argsort(g, kind="stable")
    counts = np.bincount(g[order], minlength=ndof)
    V = int(counts.max())
    inc = np.zeros((ndof, V), dtype=np.int32)
    msk = np.zeros((ndof, V))
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for v in range(V):
        sel = counts > v
        idx = starts[sel] + v
        inc[sel, v] = order[idx]
        msk[sel, v] = 1.0
    return inc, msk


def e_to_l_gather(u_e, incidence, mask):
    """Assembly via the incidence table: (..., NE, nd) -> (..., ndof)."""
    lead = u_e.shape[:-2]
    flat = u_e.reshape(lead + (-1,))
    vals = flat[..., incidence]                 # (..., ndof, V)
    return torch.sum(vals * mask, dim=-1)


def mass_apply_e(u_e, D, B, dim, oz=None):
    """Element-local mass apply: B^T (D * (B u)) on (..., NE, nd).

    u_e (..., NE, nd1^dim), D (NE, nq1^dim) and the 1D table B (nq1, nd1)
    of one dtype on one device.  A CUDA tensor goes to the kernel
    `csrc/mass.cu` (counted in `mass_apply_e.launches`), a CPU tensor to
    `mass_apply_e_plain`.

    With oz = (fwd StaticSplit (nd, NQ), bwd StaticSplit (NQ, nd)) of the
    dense operator the two products run as f64-accurate Ozaki products
    (ops/omm.py)."""
    if oz is not None:
        from . import omm

        fwd, bwd = oz
        q = omm.matmul(u_e, fwd)
        return omm.matmul(q * D, bwd)
    NE, nd1, nq1 = _check(u_e, D, B, dim)
    if u_e.device.type == "cpu":
        return mass_apply_e_plain(u_e, D, B, dim)
    if u_e.device.type != "cuda":
        raise NotImplementedError(f"no mass kernel for {u_e.device}")
    if u_e.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the mass kernel takes float32 or float64, got "
                        f"{u_e.dtype}")
    u = u_e.contiguous()
    out = torch.empty(u_e.shape, dtype=u_e.dtype, device=u_e.device)
    kernels.launch_mass(u, D.contiguous(), B.contiguous(), out,
                        C=math.prod(u.shape[:-2]), NE=NE, dim=dim,
                        nd1=nd1, nq1=nq1)
    mass_apply_e.launches += 1
    return out


mass_apply_e.launches = 0


def _check(u_e, D, B, dim):
    """(NE, nd1, nq1) of the mass apply's operands; raises on operands of
    different dtypes or devices or of shapes that do not fit together."""
    if dim not in (1, 2, 3):
        raise ValueError(f"dim must be 1, 2 or 3, got {dim}")
    if not (u_e.dtype == D.dtype == B.dtype):
        raise TypeError(f"mass apply dtypes differ: u {u_e.dtype}, D "
                        f"{D.dtype}, B {B.dtype}")
    if not (u_e.device == D.device == B.device):
        raise ValueError(f"mass apply devices differ: u {u_e.device}, D "
                         f"{D.device}, B {B.device}")
    if B.dim() != 2 or D.dim() != 2 or u_e.dim() < 2:
        raise ValueError(f"mass apply needs B (nq1, nd1), D (NE, NQ) and u "
                         f"(..., NE, nd); got {tuple(B.shape)}, "
                         f"{tuple(D.shape)}, {tuple(u_e.shape)}")
    nq1, nd1 = B.shape
    NE = D.shape[0]
    if (tuple(u_e.shape[-2:]) != (NE, nd1**dim)
            or D.shape[1] != nq1**dim):
        raise ValueError(f"mass apply shapes do not fit: u "
                         f"{tuple(u_e.shape)}, D {tuple(D.shape)}, B "
                         f"{tuple(B.shape)} in {dim}D (want u (..., {NE}, "
                         f"{nd1**dim}) and D ({NE}, {nq1**dim}))")
    return NE, nd1, nq1


def mass_apply_e_plain(u_e, D, B, dim):
    """The plain torch version of `mass_apply_e` (its kernel's twin): the
    sum-factorized chain of 1D contractions."""
    nd1 = B.shape[1]
    nq1 = B.shape[0]
    shp = u_e.shape
    ut = u_e.reshape(shp[:-1] + (nd1,) * dim)
    q = tensor.eval_values(ut, B, dim)
    Dq = D.reshape(D.shape[:-1] + (nq1,) * dim)
    q = q * Dq
    out = tensor.eval_transpose(q, B.T, dim)
    return out.reshape(shp)


def h1_mass_apply(u_l, gather, ndof, D, B, dim):
    """Assembled-action H1 mass, host setup path:
    scatter-add(B^T D B gather(u))."""
    ue = l_to_e(u_l, gather)
    ue = mass_apply_e(ue, D, B, dim)
    return e_to_l(ue, gather, ndof)


def h1_mass_diag(gather, ndof, D, B, dim):
    """Diagonal of the assembled H1 mass (Jacobi preconditioning),
    host setup path.

    diag_i = sum_e sum_q phi_i(q)^2 D(q), exploiting the tensor
    factorization phi^2 = prod B^2 (OperatorJacobiSmoother equivalent,
    laghos_solver.cpp:266-270).
    """
    nq1 = B.shape[0]
    B2t = (B * B).T
    Dq = D.reshape(D.shape[:-1] + (nq1,) * dim)
    de = tensor.eval_transpose(Dq, B2t, dim)
    de = de.reshape(D.shape[0], -1)
    return e_to_l(de, gather, ndof)


def l2_mass_matrices(D, B, dim):
    """Dense per-element L2 mass matrices M_e[i,j] = sum_q psi_i psi_j D;
    D (NE, NQ) and B the 1D table, torch tensors."""
    # full basis matrix (NQ, ld) with x-fastest lex on both axes:
    # kron(B_z, kron(B_y, B_x)) since kron puts the first factor slowest
    full = B
    for _ in range(dim - 1):
        full = torch.kron(B, full)
    return torch.einsum("qi,qj,eq->eij", full, full, D)
