"""Preconditioned conjugate gradients with MFEM-faithful semantics.

Replaces mfem::CGSolver as configured by the reference
(laghos_solver.cpp:264-284): the relative tolerance applies to the
preconditioned residual dot (r, Br) against its initial value, absolute
tolerance 0, zero initial guess.  The stopping rule, the iteration counting
and the breakdown guard are those of `laghos_tpu.solvers.cg`, so CG
iteration counts (part of the reference's FOM, laghos_solver.cpp:722) match.
An optional `x0` warm-starts the solve (mfem's iterative_mode) with the
stopping target still referenced to b.

Independent right-hand sides (the velocity components) run batched as the
rows of one (C, n) system with per-column convergence masks; no column's
iterate depends on another's.  The loop runs on the host: the `any(active)`
test reads one flag from the device, by default every iteration.  A column
that has converged takes exact no-op iterations (a zero step, its
direction and dots held), and its count is recorded at the iteration where
it converged, so reading the flag less often returns the same bits and
counts with fewer host syncs.  With `reads` (a one-element list holding
the stop of the previous solve of the same system, or None) the flag is
read at the first iteration, every _READ_PERIOD iterations, and every
iteration from two before that stop on; the CG writes back one past the
last iteration at which it read the flag still set, the earliest its own
stop could have been.  A solve whose count repeats the previous one's
then reads the flag three times near the end and runs no iteration past
its convergence; a count that jumps costs one solve of late reads.
With `graph` on the card, the iterations replay a CUDA graph of one
iteration (the same kernels, so the same bits) instead of launching each
kernel from the host.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


# the longest run of iterations without a flag read under `reads`
_READ_PERIOD = 16


def _graphed(iterate, state):
    """Static copies of the CG state and a function that runs the next
    iteration on them: its first call runs one eager iteration on a side
    stream (the warm-up) and captures a CUDA graph of `iterate`, every
    later call replays the graph.

    The graph holds the same kernels as an eager iteration, so a graphed
    solve repeats the eager one bit for bit; it saves the host its launch
    work per kernel.  The iteration number lives on the device and
    advances in the graph."""
    static = [t.clone() for t in state]
    it_t = torch.ones((), dtype=state[7].dtype, device=state[7].device)
    graph = torch.cuda.CUDAGraph()

    def body():
        for dst, src in zip(static, iterate(tuple(static), it_t)):
            dst.copy_(src)
        it_t.add_(1)

    calls = [0]

    def replay():
        if calls[0]:
            graph.replay()
        else:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                body()
            torch.cuda.current_stream().wait_stream(side)
            # torch.cuda.graph synchronizes and empties the allocator's
            # cache before the capture, which frees the private memory pools
            # of earlier solves' graphs: capturing with capture_begin/end
            # alone kept them, and a row of AMR steps ran out of the card's
            # 80 GB
            with torch.cuda.graph(graph):
                body()
        calls[0] += 1
    return static, replay


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
    x0: Optional[torch.Tensor] = None,    # (C, n) warm start
    reads: Optional[list] = None,         # [previous stop] or [None]
    graph: bool = False,                  # on the card: replay iterations
                                          # from a CUDA graph
) -> CGResult:
    M = precond if precond is not None else (lambda r: r)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    one = torch.ones((), dtype=b.dtype, device=b.device)

    if x0 is None:
        r = b
        x = torch.zeros_like(b)
        z = M(r)
        d = z
        nom = _dot(d, r)
        r0 = nom * (rel_tol * rel_tol)
    else:
        x = x0
        r = b - apply_A(x0)
        z = M(r)
        d = z
        nom = _dot(d, r)
        # the target stays referenced to b, as a cold solve's would be, so
        # a warm start saves iterations instead of solving tighter
        r0 = _dot(M(b), b) * (rel_tol * rel_tol)
    active = nom > r0
    Ad = apply_A(d)
    den = _dot(d, Ad)
    iters = torch.where(active, max_iter, 0)

    def iterate(state, it):
        x, r, d, Ad, nom, den, active, iters = state
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
        return (x, r, d, Ad, nom, den, active, iters)

    state = (x, r, d, Ad, nom, den, active, iters)
    replay = None
    if graph and b.is_cuda:
        state, replay = _graphed(iterate, state)
    near = max_iter + 1 if reads is None or reads[0] is None else reads[0] - 2
    it = seen = 1
    while it <= max_iter:
        if reads is None or (it - 1) % _READ_PERIOD == 0 or it >= near:
            if not bool(state[6].any()):
                break
            seen = it
        if replay is None:
            state = iterate(state, it)
        else:
            replay()
        it += 1
    x, active, iters = state[0], state[6], state[7]
    if reads is not None:
        reads[0] = seen + 1
    return CGResult(x, iters, ~active)
