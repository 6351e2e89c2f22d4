"""f64-accurate whole-lattice banded contractions from Ozaki int8 products.

The torch counterpart of `laghos_tpu.ops.lattice_oz`: the banded chains of
`ops/lattice.py` (mass apply, q-update gradients, force pair) with every
contraction an `ops/omm` product, where

  * the STATIC side (the banded per-axis tables and the dense L2 element
    tables) is split into int8 digits once at setup;
  * the DYNAMIC side is split once per chain stage and shared by every
    table and every field component that contracts the same intermediate
    (all components ride one batched split);
  * each contraction takes axis 1 and appends the result axis last, so the
    3-axis cycle returns to the (z, y, x) layout with no transposes.

Reference counterpart: the f64 contractions of laghos_assembly.cpp:145-514
(MassPA/ForcePA) and the QuadratureInterpolator gradients of QUpdate
(laghos_solver.cpp:1042-1168).
"""

from __future__ import annotations

import numpy as np
import torch

from . import omm
from .lattice import banded_eval_table


def build_lattice_oz(B1d, G1d, l2bd, n_zyx, n_slices=omm.S_FULL,
                     device="cpu"):
    """Static int8 splits of the per-axis banded tables (both orientations)
    and of the dense L2 element tables, on `device`.

    B1d/G1d: (nq, p+1) 1D H1 value/gradient tables (f64 host arrays); l2bd:
    (NQ, ld) dense L2 value table; n_zyx: elements per lattice axis in
    (z, y, x) order."""
    fwdB, bwdB, fwdG, bwdG = [], [], [], []
    for n in n_zyx:
        T = banded_eval_table(np.asarray(B1d, np.float64), n)
        Tg = banded_eval_table(np.asarray(G1d, np.float64), n)
        fwdB.append(omm.split_static(T, n_slices, device))
        bwdB.append(omm.split_static(T.T, n_slices, device))
        fwdG.append(omm.split_static(Tg, n_slices, device))
        bwdG.append(omm.split_static(Tg.T, n_slices, device))
    l2bd = np.asarray(l2bd, np.float64)
    return {
        "fwdB": tuple(fwdB), "bwdB": tuple(bwdB),
        "fwdG": tuple(fwdG), "bwdG": tuple(bwdG),
        "l2fwd": omm.split_static(l2bd.T, n_slices, device),
        "l2bwd": omm.split_static(l2bd, n_slices, device),
    }


def _S(loz):
    """Static slice count of a lattice_oz build."""
    return loz["fwdB"][0].n_slices


def mass_apply_lattice_oz(uL, loz, Dq, lat_dims, n_slices=None):
    """f64-accurate PA mass apply on the raster lattice (the CG-H1
    operator).  uL: (C, ndof); Dq: dense q-lattice rho0 detJ0 w.

    Chain: contract axis 1 six times, forward axes cycling (C,Lz,Ly,Lx) ->
    (C,Ly,Lx,Qz) -> (C,Lx,Qz,Qy) -> (C,Qz,Qy,Qx), pointwise Dq, then the
    transpose tables cycle back.  `n_slices` truncates the dynamic splits
    below the build's count (the IR residual applies)."""
    C = uL.shape[0]
    S = n_slices or _S(loz)
    q = uL.reshape((C,) + tuple(lat_dims))
    for k in range(3):
        q = omm.tensordot(q, loz["fwdB"][k], axis=1, n_slices=S)
    q = q * Dq[None]
    for k in range(3):
        q = omm.tensordot(q, loz["bwdB"][k], axis=1, n_slices=S)
    return q.reshape(C, -1)


def gradc_lattice_oz(uc, loz, n_slices=None):
    """f64-accurate first derivatives of a batch of lattice fields.

    uc: (C, Lz, Ly, Lx).  Returns (d_x, d_y, d_z), each (C, Qz, Qy, Qx),
    d_b[c] = d uc[c] / d xi_b (b = 0 the x direction).  All C components
    ride one batched split per chain stage, and the value and gradient
    tables that consume one intermediate share its split (6 splits, 8
    products for the whole batch)."""
    S = n_slices or _S(loz)
    fB, fG = loz["fwdB"], loz["fwdG"]
    du = omm.split_dyn(uc.contiguous(), S, axis=1)
    tzB = omm.mm(du, fB[0])                    # (C, Ly, Lx, Qz)
    tzG = omm.mm(du, fG[0])
    dB = omm.split_dyn(tzB, S, axis=1)
    tBB = omm.mm(dB, fB[1])                    # (C, Lx, Qz, Qy)
    tBG = omm.mm(dB, fG[1])
    dG = omm.split_dyn(tzG, S, axis=1)
    tGB = omm.mm(dG, fB[1])
    d_x = omm.tensordot(tBB, fG[2], axis=1, n_slices=S)  # (C, Qz, Qy, Qx)
    d_y = omm.tensordot(tBG, fB[2], axis=1, n_slices=S)
    d_z = omm.tensordot(tGB, fB[2], axis=1, n_slices=S)
    return d_x, d_y, d_z


def _j9(d_x, d_y, d_z, c0):
    """(9, Qz, Qy, Qx) stack J[a*3+b] = d u_{c0+a} / d xi_b."""
    return torch.stack([d[c0 + a] for a in range(3) for d in (d_x, d_y, d_z)])


def grad9_lattice_oz(u3, loz, n_slices=None):
    """J[a*3+b] = d u_a / d xi_b as a (9, Qz, Qy, Qx) stack (the layout of
    ops/lattice.grad9_lattice, stacked) from one batched chain."""
    return _j9(*gradc_lattice_oz(u3, loz, n_slices=n_slices), 0)


def grad18_lattice_oz(x3, v3, loz, n_slices=6):
    """(J9, dV9) for the q-update: both vector fields stacked through ONE
    batched chain (half the splits and products of two calls).  The
    gradients only set stress values, so they run at 6 slices (~2^-42) by
    default, as in the JAX package."""
    d = gradc_lattice_oz(torch.cat([x3, v3], dim=0), loz, n_slices=n_slices)
    return _j9(*d, 0), _j9(*d, 3)


def force_one_lattice_oz(sJ, loz, n_slices=None):
    """f64-accurate (F . 1) on the H1 lattice from q-lattice stress.

    sJ: (9, Qz, Qy, Qx) stack sJit[gd*3+vd]; returns (3, Lz, Ly, Lx).  For
    each reference direction gd the three velocity components share one
    batched transpose chain (9 splits, 9 products in all).  `n_slices`
    truncates the dynamic splits (Options.ozaki_rhs_slices)."""
    S = n_slices or _S(loz)
    bB, bG = loz["bwdB"], loz["bwdG"]
    acc = None
    for gd in range(3):
        s = sJ[gd * 3:gd * 3 + 3]
        Tz = bG[0] if gd == 2 else bB[0]
        Ty = bG[1] if gd == 1 else bB[1]
        Tx = bG[2] if gd == 0 else bB[2]
        t = omm.tensordot(s, Tz, axis=1, n_slices=S)   # (3, Qy, Qx, Lz)
        t = omm.tensordot(t, Ty, axis=1, n_slices=S)   # (3, Qx, Lz, Ly)
        t = omm.tensordot(t, Tx, axis=1, n_slices=S)   # (3, Lz, Ly, Lx)
        acc = t if acc is None else acc + t
    return acc


def l2_eval_oz(e_b, loz, n_slices=None):
    """(NE, ld) L2 dofs -> (NE, NQ) q-point values, f64-accurate."""
    return omm.matmul(e_b, loz["l2fwd"], n_slices or _S(loz))


def l2_transpose_oz(eq, loz, n_slices=None):
    """(NE, NQ) q-point integrand -> (NE, ld) L2 rhs, f64-accurate."""
    return omm.matmul(eq, loz["l2bwd"], n_slices or _S(loz))
