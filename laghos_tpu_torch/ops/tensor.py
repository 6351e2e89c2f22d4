"""Sum-factorized tensor-product contractions.

The replacement for MFEM's QuadratureInterpolator and the 1D contraction
structure of the reference's force kernels (laghos_assembly.cpp:145-514):
every dof<->qpoint transformation is a chain of small contractions over one
1D axis at a time, batched over the element axis (`torch.tensordot`).

Conventions
-----------
Element tensors carry their 1D axes LAST, x-axis last of all:
    u : (..., m_{d-1}, ..., m_1, m_0)    # m_0 is the x direction
which matches MFEM's lexicographic (x-fastest) flattening under C-order
reshape.  1D tables are (npts, ndof): rows are evaluation points.
"""

from __future__ import annotations

import torch


def apply_axis(u: torch.Tensor, mat: torch.Tensor, k: int, d: int):
    """Contract direction-k axis (x = 0) of `u` with `mat` (out, in)."""
    ax = u.dim() - 1 - k
    out = torch.tensordot(u, mat, dims=([ax], [1]))
    return torch.movedim(out, -1, ax)


def eval_values(u: torch.Tensor, B: torch.Tensor, d: int) -> torch.Tensor:
    """Interpolate dof tensor to the tensor point set: apply B on all axes."""
    for k in range(d):
        u = apply_axis(u, B, k, d)
    return u


def eval_gradient(u: torch.Tensor, B: torch.Tensor, G: torch.Tensor, d: int):
    """Reference-space gradient at tensor points.

    Returns shape (..., q_{d-1}, ..., q_0, d); last axis is the derivative
    direction b with du/dx̂_b.
    """
    return torch.stack([eval_gradient_dir(u, B, G, b, d) for b in range(d)],
                       dim=-1)


def eval_transpose(u: torch.Tensor, Bt: torch.Tensor, d: int) -> torch.Tensor:
    """Transpose interpolation (qpoints -> dofs): apply Bt on all axes."""
    for k in range(d):
        u = apply_axis(u, Bt, k, d)
    return u


def grad_transpose(uq: torch.Tensor, Bt: torch.Tensor, Gt: torch.Tensor,
                   b: int, d: int) -> torch.Tensor:
    """Transpose of the direction-b derivative operator."""
    for k in range(d):
        uq = apply_axis(uq, Gt if k == b else Bt, k, d)
    return uq


def eval_gradient_dir(u: torch.Tensor, B: torch.Tensor, G: torch.Tensor,
                      b: int, d: int) -> torch.Tensor:
    """Direction-b reference derivative at tensor points: (..., q...)."""
    for k in range(d):
        u = apply_axis(u, G if k == b else B, k, d)
    return u


def dense_ops(B, G, d: int):
    """Dense dof->qpoint operators from 1D tables (host NumPy): (NQ, nd)
    matrices with x the FASTEST axis on both flat indices (matching the
    gather maps and the flat W ordering).  Returns (Bd, [Gd_0 .. Gd_{d-1}]),
    as `laghos_tpu.ops.tensor.dense_ops`; the Ozaki gather path splits them
    once at setup (ops/omm.split_static)."""
    import numpy as np

    Bn = np.asarray(B)
    Gn = np.asarray(G)
    Bd = np.ones((1, 1))
    for _ in range(d):
        Bd = np.kron(Bn, Bd)      # x fastest
    Gds = []
    for b in range(d):
        M = np.ones((1, 1))
        for k in range(d):
            M = np.kron(Gn if k == b else Bn, M)
        Gds.append(M)
    return Bd, Gds
