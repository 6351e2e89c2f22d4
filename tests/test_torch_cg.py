"""The fused CG chain (`solvers/cg._Chain`: csrc/cg.cu on the card, its
plain twins on the CPU) against the eager iteration, on the CPU: the twins
run the eager formulas with every dot summed as the eager iteration sums
it, so x, the counts and the `reads` stop are equal, in every case the
chain must keep (rows converging at different iterations, a breakdown, a
warm start, the `reads` schedule, the `max_iter` cap, no preconditioner,
the essential-dof mask), and `cg` leaves its inputs as they were.  The
dispatch (`fused_path`) takes the eager iteration for a callable
preconditioner, a custom dot, a CUDA graph and CPU tensors.  This file
imports neither JAX nor `laghos_tpu`."""

import types

import numpy as np
import pytest
import torch

from laghos_tpu_torch import timing
from laghos_tpu_torch.solvers import cg as cgm

C, N = 3, 40


def _system(seed=0, indefinite_row=None, negative_row=None):
    """Three SPD (C, N, N) operators of rising condition (so the rows
    converge at different iterations), a Jacobi diagonal, b and a mask;
    one row's operator indefinite or negative definite on request."""
    rng = np.random.default_rng(seed)
    mats = []
    for c in range(C):
        q, _ = np.linalg.qr(rng.normal(size=(N, N)))
        eig = np.geomspace(1.0, 10.0 ** (1 + 1.5 * c), N)
        if c == indefinite_row:
            eig[::2] *= -1.0
        if c == negative_row:
            eig = -eig
        mats.append(q @ np.diag(eig) @ q.T)
    A = torch.tensor(np.stack(mats))
    dinv = 1.0 / torch.diagonal(A, dim1=1, dim2=2).abs()
    b = torch.tensor(rng.normal(size=(C, N)))
    ess = torch.tensor(rng.random((C, N)) < 0.1)
    b = torch.where(ess, torch.zeros_like(b), b)
    return A, dinv, b, ess


def _apply(A):
    return lambda u: torch.einsum("cij,cj->ci", A, u)


# (name, cg keyword arguments, system keyword arguments, tol, max_iter)
CASES = [
    ("rows_converge_apart", dict(precond_diag=True), {}, 1e-10, 300),
    ("breakdown", dict(precond_diag=True), dict(negative_row=1), 1e-10,
     300),
    ("indefinite", dict(precond_diag=True), dict(indefinite_row=2), 1e-10,
     300),
    ("warm_start", dict(precond_diag=True, x0=True), {}, 1e-10, 300),
    ("reads_none", dict(precond_diag=True, reads=[None]), {}, 1e-10, 300),
    ("reads_previous_stop", dict(precond_diag=True, reads=[9]), {}, 1e-10,
     300),
    ("reads_late_stop", dict(precond_diag=True, reads=[60]), {}, 1e-10,
     300),
    ("max_iter_cap", dict(precond_diag=True), {}, 1e-14, 7),
    ("no_precond", {}, {}, 1e-10, 300),
    ("no_precond_warm_reads", dict(x0=True, reads=[None]), {}, 1e-9, 300),
    ("ess_mask", dict(precond_diag=True, ess=True), {}, 1e-10, 300),
    ("ess_mask_shared_diag", dict(precond_diag="shared", ess=True,
                                  reads=[12]), {}, 1e-10, 300),
]


def _kwargs(kw, dinv, ess, b):
    out = dict(kw)
    if "precond_diag" in out:
        out["precond_diag"] = dinv[0] if out["precond_diag"] == "shared" \
            else dinv
    if out.get("ess"):
        out["ess"] = ess
    if out.get("x0"):
        out["x0"] = 0.3 * b + 0.01
    if "reads" in out:
        out["reads"] = list(out["reads"])
    return out


def _fused(monkeypatch):
    monkeypatch.setattr(cgm, "fused_path", lambda *a: True)


@pytest.mark.parametrize("name,kw,skw,tol,max_iter", CASES,
                         ids=[c[0] for c in CASES])
def test_chain_twins_match_eager(monkeypatch, name, kw, skw, tol, max_iter):
    A, dinv, b, ess = _system(**skw)
    if name == "ess_mask_shared_diag":
        dinv = dinv[:1].expand(C, -1).contiguous()
    apply = _apply(A)
    kw_e = _kwargs(kw, dinv, ess, b)
    kw_f = _kwargs(kw, dinv, ess, b)
    b_before = b.clone()
    x0_before = None if "x0" not in kw_f else kw_f["x0"].clone()
    eager = cgm.cg(apply, b, tol, max_iter, **kw_e)
    _fused(monkeypatch)
    with timing.trace() as tr:
        fused = cgm.cg(apply, b, tol, max_iter, **kw_f)
    assert torch.equal(fused.x, eager.x), name
    assert torch.equal(fused.iters, eager.iters), name
    assert torch.equal(fused.converged, eager.converged), name
    assert kw_f.get("reads") == kw_e.get("reads"), name
    assert set(tr.cg_iters) == {("", "fused")}
    # the chain updates its own copies, never the caller's b or x0
    assert torch.equal(b, b_before)
    if x0_before is not None:
        assert torch.equal(kw_f["x0"], x0_before)
    its = eager.iters.tolist()
    if name == "rows_converge_apart":
        assert len(set(its)) == C and max(its) < max_iter
    if name == "breakdown":
        # den < 0 at the first iteration: the row freezes at x = 0 there
        assert its[1] == 1 and not bool(eager.x[1].any())
        assert its[0] > 1 and its[2] > 1
    if name == "max_iter_cap":
        assert its == [max_iter] * C and not bool(eager.converged.any())


@pytest.mark.parametrize("reads", [[None], [5], [40]])
def test_chain_reads_same_bits_as_every_read(monkeypatch, reads):
    """The chain with fewer flag reads returns the bits and counts of the
    chain reading the flag every iteration."""
    A, dinv, b, ess = _system(seed=3)
    _fused(monkeypatch)
    every = cgm.cg(_apply(A), b, 1e-11, 300, precond_diag=dinv, ess=ess)
    with timing.trace() as tr:
        fewer = cgm.cg(_apply(A), b, 1e-11, 300, precond_diag=dinv, ess=ess,
                       reads=list(reads))
    assert torch.equal(every.x, fewer.x)
    assert torch.equal(every.iters, fewer.iters)
    assert sum(tr.reads.values()) <= int(every.iters.max()) + 1


def _stand_in(cuda=True, dtype=torch.float64, dim=2):
    return types.SimpleNamespace(is_cuda=cuda, dtype=dtype,
                                 dim=lambda: dim)


@pytest.mark.parametrize("b,precond,dot,graph,want", [
    (_stand_in(), None, None, False, True),
    (_stand_in(dtype=torch.float32), None, None, False, True),
    (_stand_in(), lambda r: r, None, False, False),
    (_stand_in(), None, cgm.sum_dot, False, False),
    (_stand_in(), None, None, True, False),
    (_stand_in(cuda=False), None, None, False, False),
    (_stand_in(dtype=torch.float16), None, None, False, False),
    (_stand_in(dim=1), None, None, False, False),
], ids=["diag_or_none", "f32", "callable_precond", "custom_dot", "graph",
        "cpu", "f16", "one_dim"])
def test_fused_path_dispatch(b, precond, dot, graph, want):
    assert cgm.fused_path(b, precond, dot, graph) is want


def test_cpu_solves_count_generic():
    """On the CPU `cg` runs the eager iteration and counts its iterations
    as "generic" against the innermost open span, once per iteration."""
    A, dinv, b, ess = _system(seed=5)
    with timing.trace() as tr:
        with timing.span("laghos.cg_h1"):
            res = cgm.cg(_apply(A), b, 1e-10, 300, precond_diag=dinv)
    assert tr.cg_iters == {("laghos.cg_h1", "generic"):
                           int(res.iters.max())}


def test_precond_and_diag_exclusive():
    A, dinv, b, ess = _system()
    with pytest.raises(ValueError):
        cgm.cg(_apply(A), b, 1e-10, 10, precond=lambda r: r,
               precond_diag=dinv)
