"""Preconditioned conjugate gradients with MFEM-faithful semantics.

Replaces mfem::CGSolver as configured by the reference
(laghos_solver.cpp:264-284): the relative tolerance applies to the
preconditioned residual dot (r, Br) against its initial value, absolute
tolerance 0, zero initial guess.  The stopping rule, the iteration counting
and the breakdown guard are those of `laghos_tpu.solvers.cg`, so CG
iteration counts (part of the reference's FOM, laghos_solver.cpp:722) match.

Independent right-hand sides (the velocity components) run batched as the
rows of one (C, n) system with per-column convergence masks; no column's
iterate depends on another's.  The loop runs on the host: the `any(active)`
test reads one flag from the device per iteration.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: torch.Tensor       # (C,) iterations used per column
    converged: torch.Tensor   # (C,) bool


def _dot(u, v):
    return torch.sum(u * v, dim=-1)


def cg(
    apply_A: Callable,                    # (C, n) -> (C, n)
    b: torch.Tensor,                      # (C, n)
    rel_tol: float,
    max_iter: int,
    precond: Optional[Callable] = None,   # (C, n) -> (C, n)
) -> CGResult:
    M = precond if precond is not None else (lambda r: r)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    one = torch.ones((), dtype=b.dtype, device=b.device)

    r = b
    x = torch.zeros_like(b)
    z = M(r)
    d = z
    nom = _dot(d, r)
    r0 = nom * (rel_tol * rel_tol)
    active = nom > r0
    Ad = apply_A(d)
    den = _dot(d, Ad)
    iters = torch.where(active, max_iter, 0)

    it = 1
    while it <= max_iter and bool(active.any()):
        # Breakdown guard: an SPD operator gives den > 0; den <= 0 can only
        # be roundoff noise, so the column freezes at its current iterate
        # (mfem CGSolver prints "not positive definite" here).
        broke = active & (den <= 0.0)
        iters = torch.where(broke, it, iters)
        active = active & ~broke
        safe_den = torch.where(den == 0.0, one, den)
        alpha = nom / safe_den
        am = torch.where(active, alpha, zero)[..., None]
        x = x + am * d
        r = r - am * Ad
        z = M(r)
        betanom = _dot(r, z)
        just_conv = active & (betanom <= r0)
        iters = torch.where(just_conv, it, iters)
        active = active & ~just_conv
        beta = betanom / torch.where(nom == 0.0, one, nom)
        bm = torch.where(active, beta, zero)[..., None]
        act = active[..., None]
        d = torch.where(act, z + bm * d, d)
        Ad = torch.where(act, apply_A(d), Ad)
        den = torch.where(active, _dot(d, Ad), den)
        nom = torch.where(active, betanom, nom)
        it += 1
    return CGResult(x, iters, ~active)
