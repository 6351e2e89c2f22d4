"""State transfer across AMR events (refine / derefine).

Equivalent of the reference's AMRUpdate + FESpace::GetUpdateOperator
interpolation (amr/laghos.cpp:761-796), ported from
`laghos_tpu.amr.transfer` as it is (NumPy, host side, run at mesh changes
only): H1 fields transfer by polynomial interpolation (exact on
refinement, point-sampling on derefinement), the L2 energy in its nodal
Gauss-Legendre basis by point evaluation of the parent on refinement and
MFEM's pointwise nodal restriction on derefinement.
"""

from __future__ import annotations

import numpy as np

from ..fem import basis as fb
from ..fem import quadrature as fq


class TransferPlan:
    """Per-new-leaf provenance between two forest states."""

    SAME, CHILD, PARENT = 0, 1, 2

    def __init__(self, old_order, new_order, dim):
        old_set = {k: i for i, k in enumerate(old_order)}
        self.dim = dim
        self.entries = []
        for (k, idx) in new_order:
            if (k, idx) in old_set:
                self.entries.append((self.SAME, old_set[(k, idx)], None))
                continue
            parent = (k - 1, tuple(v >> 1 for v in idx))
            if parent in old_set:
                bits = tuple(idx[d] & 1 for d in range(dim))
                self.entries.append((self.CHILD, old_set[parent], bits))
                continue
            # derefined: the 2^dim children were old leaves
            kids = []
            for c in np.ndindex(*(2,) * dim):
                c = tuple(reversed(c))
                cidx = tuple(2 * idx[d] + c[d] for d in range(dim))
                kids.append((c, old_set[(k + 1, cidx)]))
            self.entries.append((self.PARENT, None, kids))


def _tensor_apply(vals, mats, dim):
    """Apply 1D matrices per axis to (..., n^dim)-flattened values."""
    n_in = mats[0].shape[1]
    n_out = mats[0].shape[0]
    lead = vals.shape[:-1]
    out = vals.reshape(lead + (n_in,) * dim)
    for k in range(dim):
        ax = out.ndim - 1 - k
        out = np.moveaxis(np.tensordot(out, mats[k], axes=[[ax], [1]]),
                          -1, ax)
    return out.reshape(lead + (n_out**dim,))


class H1Transfer:
    def __init__(self, p, dim):
        gl = fq.gauss_lobatto(p + 1)
        BL, _ = fb.lagrange_tables(gl, gl / 2.0)
        BR, _ = fb.lagrange_tables(gl, 0.5 + gl / 2.0)
        self.child = (BL, BR)
        # derefinement: parent node from the child containing it
        DL = np.zeros((p + 1, p + 1))
        DR = np.zeros((p + 1, p + 1))
        for a, t in enumerate(gl):
            if t <= 0.5:
                B, _ = fb.lagrange_tables(gl, np.array([2.0 * t]))
                DL[a] = B[0]
            else:
                B, _ = fb.lagrange_tables(gl, np.array([2.0 * t - 1.0]))
                DR[a] = B[0]
        self.parent = (DL, DR)
        self.dim = dim
        self.nd = (p + 1) ** dim

    def element_values(self, plan: TransferPlan, old_evals):
        """old_evals: (C, NE_old, nd) -> (C, NE_new, nd)."""
        C = old_evals.shape[0]
        d = self.dim
        out = np.zeros((C, len(plan.entries), self.nd))
        BL, BR = self.child
        DL, DR = self.parent
        for li, (kind, src, extra) in enumerate(plan.entries):
            if kind == TransferPlan.SAME:
                out[:, li] = old_evals[:, src]
            elif kind == TransferPlan.CHILD:
                mats = [BR if extra[k] else BL for k in range(d)]
                out[:, li] = _tensor_apply(old_evals[:, src], mats, d)
            else:
                acc = np.zeros((C, self.nd))
                for bits, oi in extra:
                    mats = [DR if bits[k] else DL for k in range(d)]
                    acc += _tensor_apply(old_evals[:, oi], mats, d)
                out[:, li] = acc
        return out


_MFEM_CHILD_ORDER = {
    # NCMesh child creation order = geometry vertex order: the
    # derefinement operator's "last covering child wins" tie-break
    # follows this order (fespace.cpp DerefinementOperator::Mult
    # overwrites rows per fine element in mesh order)
    2: [(0, 0), (1, 0), (1, 1), (0, 1)],
    3: [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
        (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)],
}


def _pointwise_deref(nodes1d, p, dim):
    """Per-child parent-restriction matrices for MFEM's nodal
    derefinement (NodalFiniteElement::GetLocalRestriction): parent dof
    at node t = the child polynomial evaluated at the node, taken from
    the LAST child (in creation order) whose reference domain contains
    it.  Returns {child_bits: (ld, ld) matrix}; summing the per-child
    applications reproduces the row-overwrite semantics because each
    parent row is nonzero in exactly one child's matrix."""
    n1 = len(nodes1d)
    ld = n1 ** dim
    rng = np.arange(n1)
    grids = np.meshgrid(*([rng] * dim), indexing="ij")
    lat = np.stack([g.reshape(-1, order="F") for g in grids], axis=1)
    eps = 1e-12
    owner = np.full(ld, -1)
    order = _MFEM_CHILD_ORDER[dim]
    for ci, bits in enumerate(order):
        ok = np.ones(ld, dtype=bool)
        for dd in range(dim):
            t = nodes1d[lat[:, dd]]
            loc = 2.0 * t - bits[dd]
            ok &= (loc >= -eps) & (loc <= 1.0 + eps)
        owner[ok] = ci                      # later child overwrites
    mats = {}
    for ci, bits in enumerate(order):
        R = np.zeros((ld, ld))
        rows = np.where(owner == ci)[0]
        for a in rows:
            wlist = []
            for dd in range(dim):
                t = nodes1d[lat[a, dd]]
                loc = np.clip(2.0 * t - bits[dd], 0.0, 1.0)
                B, _ = fb.lagrange_tables(nodes1d, np.array([loc]))
                wlist.append(B[0])
            for cn in range(ld):
                w = 1.0
                for dd in range(dim):
                    w *= wlist[dd][lat[cn, dd]]
                R[a, cn] = w
        mats[tuple(bits)] = R
    return mats


class L2Transfer:
    def __init__(self, p, dim):
        # nodal GL basis (the reference AMR build does not use Bernstein:
        # amr/README "Limitations"): refinement = point evaluation of the
        # parent polynomial at the child node positions
        gln, _ = fq.gauss_legendre(p + 1)
        EL, _ = fb.lagrange_tables(gln, gln / 2.0)
        ER, _ = fb.lagrange_tables(gln, 0.5 + gln / 2.0)
        self.child = (EL, ER)
        # derefinement: MFEM uses pointwise nodal restriction (fe.cpp
        # NodalFiniteElement::GetLocalRestriction via
        # GetLocalDerefinementMatrices), NOT an L2 projection — each
        # parent node takes the value of the last covering child's
        # polynomial at that node.  (This is exactly why the AMR build
        # needs the nodal basis: Positive/Bernstein elements have no
        # GetLocalRestriction.)
        self.parent_sel = _pointwise_deref(gln, p, dim)
        self.dim = dim
        self.ld = (p + 1) ** dim

    def element_values(self, plan: TransferPlan, old_e):
        """old_e: (NE_old, ld) -> (NE_new, ld)."""
        d = self.dim
        out = np.zeros((len(plan.entries), self.ld))
        EL, ER = self.child
        for li, (kind, src, extra) in enumerate(plan.entries):
            if kind == TransferPlan.SAME:
                out[li] = old_e[src]
            elif kind == TransferPlan.CHILD:
                mats = [ER if extra[k] else EL for k in range(d)]
                out[li] = _tensor_apply(old_e[src][None], mats, d)[0]
            else:
                acc = np.zeros(self.ld)
                for bits, oi in extra:
                    acc += self.parent_sel[tuple(bits)] @ old_e[oi]
                out[li] = acc
        return out
