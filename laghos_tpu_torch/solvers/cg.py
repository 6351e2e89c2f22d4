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
kernel from the host.  `dot` replaces the per-column dot product, as in
`laghos_tpu.solvers.cg`: a distributed solve passes one that sums the
rank's owned entries across ranks (every rank then reads the same flags
and stops at the same iteration); a collective cannot sit inside a CUDA
graph, so such a solve runs with graph=False.

The fused chain: on the card, with no preconditioner or a diagonal one
given as a tensor (`precond_diag`), the one-device dot and no graph
(`fused_path`), an iteration's vector algebra runs as the hand-written
kernels of `csrc/cg.cu` around the operator apply (`_Chain`): the same
values as the iteration above but for the order in which the dots are
summed (fixed, so two solves give the same bits), about 8 launches and
13 passes over a (C, n) vector instead of about 35 and 36.  `ess` (the
essential-dof mask) zeroes the operator's output there, inside the
chain's dot kernel on that path.  Every other solve runs the iteration
above.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..ops import kernels
from ..timing import count_cg, host_read

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


def sum_dot(u, v):
    """The one-device per-row dot: (C, n), (C, n) -> (C,)."""
    return torch.sum(u * v, dim=-1)


def _masked(ess, y):
    return torch.where(ess, torch.zeros_like(y), y)


def fused_path(b, precond, dot, graph) -> bool:
    """Whether `cg` runs the fused chain: b a (C, n) f32 or f64 CUDA
    tensor, no callable preconditioner, the one-device dot (`dot` None)
    and no CUDA graph."""
    return (b.is_cuda and b.dim() == 2
            and b.dtype in (torch.float32, torch.float64)
            and precond is None and dot is None and not graph)


def _private(t, *taken):
    """t, or a contiguous copy where it is not contiguous or starts where
    one of `taken` (tensors or None) does: the chain updates it in place."""
    ptrs = {u.data_ptr() for u in taken if u is not None}
    if t.is_contiguous() and t.data_ptr() not in ptrs:
        return t
    return t.clone(memory_format=torch.contiguous_format)


class _Chain:
    """The state of a fused solve, updated in place: x, r, d, Ad (C, n);
    nom, den, r0, active, iters and beta (C,); `flag`, the 0-d int32 that
    says whether a row is still active, which the host reads.  An
    iteration (`iterate`) is `chain_step` (the update, the finisher and
    the direction), the operator apply on d, and `chain_ess_dot` (the mask
    and den); Ad is the last apply's output, masked.  On the card the
    steps launch csrc/cg.cu, on the CPU their plain twins run."""

    def __init__(self, apply_A, x, r, d, Ad, nom, den, r0, active, iters,
                 dinv, ess):
        self.apply_A, self.dinv, self.ess = apply_A, dinv, ess
        self.x, self.r, self.d, self.Ad = x, r, d, Ad
        self.nom, self.den, self.r0 = nom, den, r0
        self.active, self.iters = active, iters
        self.beta = torch.zeros_like(nom)
        self.flag = active.any().to(torch.int32)
        self.launch = (kernels.CGLaunch(x, r, d, nom, den, r0, active, iters,
                                        self.beta, self.flag, dinv, ess)
                       if x.is_cuda else None)
        self._ptrs = (x.data_ptr(), r.data_ptr(), d.data_ptr())

    def iterate(self, it):
        chain_step(self, it)
        chain_ess_dot(self, self.apply_A(self.d))


def _z(ch):
    return ch.r if ch.dinv is None else ch.r * ch.dinv


def _step_plain(ch, it):
    """The plain twin of `chain_step` (csrc/cg.cu steps 1-3): the eager
    iteration's formulas on the rows still active, the others untouched."""
    zero = torch.zeros((), dtype=ch.x.dtype, device=ch.x.device)
    one = torch.ones((), dtype=ch.x.dtype, device=ch.x.device)
    act = ch.active & ~(ch.den <= 0.0)
    alpha = ch.nom / torch.where(ch.den == 0.0, one, ch.den)
    am = torch.where(act, alpha, zero)[..., None]
    rows = act[..., None]
    ch.x.copy_(torch.where(rows, ch.x + am * ch.d, ch.x))
    ch.r.copy_(torch.where(rows, ch.r - am * ch.Ad, ch.r))
    betanom = sum_dot(ch.r, _z(ch))
    broke = ch.active & (ch.den <= 0.0)
    iters = torch.where(broke, it, ch.iters)
    active = ch.active & ~broke
    just_conv = active & (betanom <= ch.r0)
    ch.iters.copy_(torch.where(just_conv, it, iters))
    active = active & ~just_conv
    beta = betanom / torch.where(ch.nom == 0.0, one, ch.nom)
    ch.beta.copy_(torch.where(active, beta, zero))
    ch.nom.copy_(torch.where(active, betanom, ch.nom))
    ch.active.copy_(active)
    ch.flag.copy_(active.any())
    ch.d.copy_(torch.where(active[..., None],
                           _z(ch) + ch.beta[..., None] * ch.d, ch.d))


def chain_step(ch, it):
    """Steps 1-3 of the fused iteration `it` on the chain `ch`: x and r
    updated, (r, z) and the row tests, beta, nom, active, iters and the
    flag, then d.  A CUDA chain launches csrc/cg.cu (counted in
    `chain_step.launches`), a CPU one runs the plain twin."""
    if ch.launch is None:
        _step_plain(ch, it)
        return
    ch.launch.step(it, ch.Ad)
    chain_step.launches += 1


chain_step.launches = 0


def _ess_dot_plain(ch, y):
    """The plain twin of `chain_ess_dot` (csrc/cg.cu step 5)."""
    if ch.ess is not None:
        y = _masked(ch.ess, y)
    ch.den.copy_(torch.where(ch.active, sum_dot(ch.d, y), ch.den))
    ch.Ad = y


def chain_ess_dot(ch, y):
    """Step 5 of the fused iteration on the operator's output y: zero at
    the essential dofs (in place on the card), den = (d, y) on the rows
    still active; y becomes Ad.  Counted in `chain_ess_dot.launches` where
    it launches csrc/cg.cu."""
    if ch.launch is None:
        _ess_dot_plain(ch, y)
        return
    if not y.is_contiguous() or y.data_ptr() in ch._ptrs:
        y = y.clone(memory_format=torch.contiguous_format)
    ch.launch.ess_dot(y)
    ch.Ad = y
    chain_ess_dot.launches += 1


chain_ess_dot.launches = 0


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
    dot: Optional[Callable] = None,       # (C, n), (C, n) -> (C,)
    precond_diag: Optional[torch.Tensor] = None,  # (n,) or (C, n): z = r d
    ess: Optional[torch.Tensor] = None,   # bool (n,) or (C, n): A u = 0 there
) -> CGResult:
    if precond_diag is not None:
        if precond is not None:
            raise ValueError("cg takes precond or precond_diag, not both")

        def M(r):
            return r * precond_diag
    else:
        M = precond if precond is not None else (lambda r: r)
    A = apply_A if ess is None else (lambda u: _masked(ess, apply_A(u)))
    _dot = dot if dot is not None else sum_dot
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
        r = b - A(x0)
        z = M(r)
        d = z
        nom = _dot(d, r)
        # the target stays referenced to b, as a cold solve's would be, so
        # a warm start saves iterations instead of solving tighter
        r0 = _dot(M(b), b) * (rel_tol * rel_tol)
    active = nom > r0
    Ad = A(d)
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
        Ad = torch.where(act, A(d), Ad)
        den = torch.where(active, _dot(d, Ad), den)
        nom = torch.where(active, betanom, nom)
        return (x, r, d, Ad, nom, den, active, iters)

    fused = fused_path(b, precond, dot, graph)
    if fused:
        x = _private(x, b, x0)
        r = _private(r, b, x0, x)
        d = _private(d, b, x0, x, r)
        Ad = _private(Ad, b, x0, x, r, d)
        ch = _Chain(apply_A, x, r, d, Ad, nom, den, r0, active, iters,
                    precond_diag, ess)
        advance = ch.iterate

        def running():
            return ch.flag
    else:
        state = [(x, r, d, Ad, nom, den, active, iters)]
        replay = None
        if graph and b.is_cuda:
            state[0], replay = _graphed(iterate, state[0])

        def advance(it):
            if replay is None:
                state[0] = iterate(state[0], it)
            else:
                replay()

        def running():
            return state[0][6].any()
    near = max_iter + 1 if reads is None or reads[0] is None else reads[0] - 2
    it = seen = 1
    while it <= max_iter:
        if reads is None or (it - 1) % _READ_PERIOD == 0 or it >= near:
            if not host_read(running()):
                break
            seen = it
        advance(it)
        it += 1
    count_cg("fused" if fused else "generic", it - 1)
    if fused:
        x, active, iters = ch.x, ch.active, ch.iters
    else:
        x, active, iters = state[0][0], state[0][6], state[0][7]
    if reads is not None:
        reads[0] = seen + 1
    return CGResult(x, iters, ~active)
