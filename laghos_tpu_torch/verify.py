"""Verification: the reference's early-step `--checks` gate and the
exact-solution velocity error norms."""

from __future__ import annotations

import numpy as np

from . import problems
from .fem import basis as fb
from .fem import quadrature as fq

# Early-step |e| regression table (laghos.cpp:1441-1463): per dim/problem,
# (step, norm) checked to relative tolerance 1e-13.
CHECKS_TABLE = {
    2: {
        0: [(5, 6.546538624534384e+00), (27, 7.588576357792927e+00)],
        1: [(5, 3.508254945225794e+00), (15, 2.756444596823211e+00)],
        2: [(5, 1.020745795651244e+01), (59, 1.721590205901898e+01)],
        3: [(5, 8.0), (16, 8.0)],
        4: [(5, 3.446324942352448e+01), (18, 3.446844033767240e+01)],
        5: [(5, 1.030899557252528e+01), (36, 1.057362418574309e+01)],
        6: [(5, 8.039707010835693e+00), (36, 8.316970976817373e+00)],
        7: [(5, 1.514929259650760e+01), (25, 1.514931278155159e+01)],
    },
    3: {
        0: [(5, 1.198510951452527e+03), (188, 1.199384410059154e+03)],
        1: [(5, 6.695818592962833e+00), (20, 4.267902387082487e+00)],
        2: [(5, 2.041491591302486e+01), (59, 3.443180411803796e+01)],
        3: [(5, 1.6e+01), (16, 1.6e+01)],
        4: [(5, 6.892649884704898e+01), (18, 6.893688067534482e+01)],
        5: [(5, 2.061984481890964e+01), (36, 2.114519664792607e+01)],
        6: [(5, 1.607988713996459e+01), (36, 1.662736010353023e+01)],
        7: [(5, 3.029858112572883e+01), (24, 3.029858832743707e+01)],
    },
}


# The --checks tolerance of the Ozaki mode: its q-update gradients truncate
# at 6 slices (~2^-42), so 3D Sedov |e| departs from the native run by
# 1.46e-13 at step 20 (tests/test_torch_ozaki.py); the gate is twice that.
OZAKI_CHECKS_EPS = 3e-13


def run_checks(problem: int, dim: int, norms: dict, eps: float = 1e-13):
    """The --checks gate (laghos.cpp:1417-1474): both table entries must
    have been sampled and match to relative tolerance eps."""
    fired = 0
    for step, ref in CHECKS_TABLE[dim][problem]:
        got = norms.get(step)
        if got is None:
            raise AssertionError(f"check step {step} was not sampled")
        rel = max(abs((got - ref) / ref), abs((got - ref) / got))
        if rel >= eps:
            raise AssertionError(
                f"P{problem} #{step}: {got:.15e} vs {ref:.15e} rel {rel:.2e}")
        fired += 1
    if fired != 2:
        raise AssertionError("Check error!")
    return True


def velocity_error_norms(hydro, S):
    """(L_inf, L_1, L_2) norms of v - v_exact(x) on the current mesh, the
    reference's steady-state velocity error report for Taylor-Green and
    Gresho (laghos.cpp:970-983), sampled at MFEM's default error rule of
    order 2p + 3.  Host NumPy on a copy of the state, as
    `laghos_tpu.verify.velocity_error_norms`."""
    d = hydro.dim
    opt = hydro.opt
    nq1 = fq.points_for_order(2 * opt.order_v + 3)
    _, w1 = fq.gauss_legendre(nq1)
    W = w1
    for _ in range(d - 1):
        W = np.kron(w1, W)
    h1b = fb.h1_gl_basis(opt.order_v, nq1)

    gather = hydro.h1.gather
    x_e = S["x"].detach().cpu().numpy()[:, gather].transpose(1, 0, 2)
    v_e = S["v"].detach().cpu().numpy()[:, gather].transpose(1, 0, 2)
    NE = hydro.NE

    def at_q(u_e):
        ut = u_e.reshape((NE, d) + (hydro.nd1,) * d)
        for k in range(d):
            ax = ut.ndim - 1 - k
            ut = np.moveaxis(np.tensordot(ut, h1b.B, axes=[[ax], [1]]),
                             -1, ax)
        return np.moveaxis(ut.reshape(NE, d, -1), 1, 2)  # (NE, NQ, d)

    xq = at_q(x_e)
    vq = at_q(v_e)
    vex = problems.v0(opt.problem, xq, d)

    # detJ at the error rule points
    xt = x_e.reshape((NE, d) + (hydro.nd1,) * d)
    J = np.zeros((NE, W.size, d, d))
    for b in range(d):
        ut = xt
        for k in range(d):
            mat = h1b.G if k == b else h1b.B
            ax = ut.ndim - 1 - k
            ut = np.moveaxis(np.tensordot(ut, mat, axes=[[ax], [1]]), -1, ax)
        J[..., b] = np.moveaxis(ut.reshape(NE, d, -1), 1, 2)
    detJ = np.abs(np.linalg.det(J))

    err = np.linalg.norm(vq - vex, axis=-1)          # (NE, NQ)
    linf = float(err.max())
    l1 = float(np.sum(W[None, :] * detJ * err))
    l2 = float(np.sqrt(np.sum(W[None, :] * detJ * err**2)))
    return linf, l1, l2
