"""Matrix-free force operator: the L2<->H1 coupling of momentum and energy.

The reference's ForcePAOperator (laghos_assembly.cpp:123-973).  The
bilinear form is
    F[i(vd), j] = sum_q  (dhat_gd phi_i)(q) * stressJinvT[gd, vd](q) * psi_j(q)
with phi the H1 basis, psi the L2 basis and stressJinvT the per-point
(stress . J^{-1})^T w detJ data produced by the q-update.  Both the action
(energy -> momentum RHS) and its transpose (velocity -> energy RHS) are
chains of sum-factorized contractions over the element axis.
"""

from __future__ import annotations

import torch

from . import tensor


def _flush(out, ftz_eps2):
    """Flush tiny per-element values to zero (laghos_assembly.cpp:159-160,
    278-292): the only flush the port makes."""
    return torch.where(torch.abs(out) < ftz_eps2, torch.zeros_like(out), out)


def force_mult(e_b, sJit, tables, *, dim: int, ftz_eps2: float):
    """F . e  ->  H1 E-vector (NE, dim, nd); sJit is (NE, NQ, d, d).

    Mirrors ForceMult2D/3D (laghos_assembly.cpp:145-514) including the
    eps^2 flush-to-zero."""
    d = dim
    H1Bt, H1Gt, L2B = tables["H1B"].T, tables["H1G"].T, tables["L2B"]
    NE = e_b.shape[0]
    l1d = L2B.shape[1]
    nq1 = L2B.shape[0]
    nd1 = H1Bt.shape[0]

    et = e_b.reshape((NE,) + (l1d,) * d)
    EQ = tensor.eval_values(et, L2B, d)            # (NE, q...)
    sJ = sJit.reshape((NE,) + (nq1,) * d + (d, d))

    comps = []
    for vd in range(d):
        acc = None
        for gd in range(d):
            term = tensor.grad_transpose(
                EQ * sJ[..., gd, vd], H1Bt, H1Gt, gd, d)
            acc = term if acc is None else acc + term
        comps.append(acc)
    out = torch.stack(comps, dim=1).reshape(NE, d, nd1**d)
    return _flush(out, ftz_eps2)


def force_mult_transpose(v_e, sJit, tables, *, dim: int):
    """F^T . v  ->  L2 vector (NE, l2d); sJit is (NE, NQ, d, d)."""
    d = dim
    H1B, H1G, L2Bt = tables["H1B"], tables["H1G"], tables["L2B"].T
    NE = v_e.shape[0]
    nd1 = H1B.shape[1]
    nq1 = H1B.shape[0]
    l1d = L2Bt.shape[0]

    vt = v_e.reshape((NE, d) + (nd1,) * d)
    dV = tensor.eval_gradient(vt, H1B, H1G, d)     # (NE, vd, q..., gd)
    sJ = sJit.reshape((NE,) + (nq1,) * d + (d, d))
    # eq_rhs(q) = sum_vd sum_gd dV[vd, q, gd] * sJ[q, gd, vd]
    eq = torch.einsum("ev...g,e...gv->e...", dV, sJ)
    out = tensor.eval_transpose(eq, L2Bt, d)
    return out.reshape(NE, l1d**d)


def force_mult9(e_b, sJit9, tables, *, ftz_eps2: float):
    """3D F . e with sJit as a (9, NE, NQ) component stack, index
    [gd * 3 + vd]; same sum-factorized math as force_mult."""
    d = 3
    H1Bt, H1Gt, L2B = tables["H1B"].T, tables["H1G"].T, tables["L2B"]
    NE = e_b.shape[0]
    l1d = L2B.shape[1]
    nq1 = L2B.shape[0]
    nd1 = H1Bt.shape[0]

    et = e_b.reshape((NE,) + (l1d,) * d)
    EQ = tensor.eval_values(et, L2B, d)            # (NE, q...)
    qshape = (NE,) + (nq1,) * d
    comps = []
    for vd in range(d):
        acc = None
        for gd in range(d):
            sq = sJit9[gd * d + vd].reshape(qshape)
            term = tensor.grad_transpose(EQ * sq, H1Bt, H1Gt, gd, d)
            acc = term if acc is None else acc + term
        comps.append(acc)
    out = torch.stack(comps, dim=1).reshape(NE, d, nd1**d)
    return _flush(out, ftz_eps2)


def force_mult_transpose9(v_e, sJit9, tables):
    """3D F^T . v with (9, NE, NQ) q-data (see force_mult9)."""
    d = 3
    H1B, H1G, L2Bt = tables["H1B"], tables["H1G"], tables["L2B"].T
    NE = v_e.shape[0]
    nd1 = H1B.shape[1]
    nq1 = H1B.shape[0]
    l1d = L2Bt.shape[0]

    vt = v_e.reshape((NE, d) + (nd1,) * d)
    qshape = (NE,) + (nq1,) * d
    eq = None
    for vd in range(d):
        for gd in range(d):
            dv = tensor.eval_gradient_dir(vt[:, vd], H1B, H1G, gd, d)
            term = dv * sJit9[gd * d + vd].reshape(qshape)
            eq = term if eq is None else eq + term
    out = tensor.eval_transpose(eq, L2Bt, d)
    return out.reshape(NE, l1d**d)
