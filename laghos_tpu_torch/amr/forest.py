"""2:1 refinement forest over a Cartesian box — the AMR mesh layer.

The port of `laghos_tpu.amr.forest`, pure NumPy and unchanged in its
numbering (the hanging-node constraints and the node ids are equal to the
JAX package's, as tests/test_torch_amr.py checks).  A re-design of the
reference AMR variant's mesh machinery
(amr/laghos.cpp:628-719, MFEM ParNCMesh): leaves of a quad/oct forest over
an axis-aligned base grid, with the 2:1 (nc_limit=1) balance rule and
hanging-node interpolation constraints.

Everything is exact integer arithmetic on a global lattice: a leaf at
depth k with level-k cell index i covers [i, i+1]*2^(D-k) level-D cells,
and its order-p H1 node (a) sits at integer coordinate (i*p + a)*2^(D-k).
Node identification across depths is therefore a row-deduplication
(`fem.mesh.unify_rows`, the sorted deduplication the JAX package runs
natively), and slave/master constraint detection is pure index
arithmetic — no floating-point geometry, no orientation case analysis.
"""

from __future__ import annotations

import numpy as np

from ..fem.basis import lagrange_tables
from ..fem.mesh import unify_rows
from ..fem.quadrature import gauss_lobatto


class Forest:
    """Adaptive 2:1-balanced forest on [0,Sx]x[0,Sy](x[0,Sz])."""

    def __init__(self, dim, base_n, sizes, max_depth):
        self.dim = dim
        self.base_n = tuple(int(v) for v in base_n[:dim])
        self.sizes = tuple(float(s) for s in sizes[:dim])
        self.max_depth = int(max_depth)
        self.leaves: dict[tuple, int] = {}
        for idx in np.ndindex(*reversed(self.base_n)):
            key = (0, tuple(reversed(idx)))
            self.leaves[key] = 1
        self._order = sorted(self.leaves)

    @classmethod
    def from_leaves(cls, dim, base_n, sizes, max_depth, leaves):
        """Reconstruct a forest from a serialized leaf-key list
        (checkpoint/resume for long AMR golden runs)."""
        f = cls.__new__(cls)
        f.dim = int(dim)
        f.base_n = tuple(int(v) for v in base_n[:dim])
        f.sizes = tuple(float(s) for s in sizes[:dim])
        f.max_depth = int(max_depth)
        f.leaves = {(int(k), tuple(int(v) for v in idx)): 1
                    for (k, idx) in leaves}
        f._order = sorted(f.leaves)
        return f

    # -- basic queries ----------------------------------------------------
    def leaf_list(self):
        return self._order

    @property
    def num_leaves(self):
        return len(self.leaves)

    def depths(self):
        return np.array([k for (k, _) in self._order], dtype=np.int32)

    def _exists(self, key):
        return key in self.leaves

    def _neighbor_exists_coarser(self, depth, idx, d, side):
        """Does the face neighbor (direction d, side +-1) exist at any
        admissible depth?  Returns the neighbor depth or None (domain bdr)."""
        n_at = [self.base_n[k] << depth for k in range(self.dim)]
        j = list(idx)
        j[d] += side
        if j[d] < 0 or j[d] >= n_at[d]:
            return None
        # check same depth, coarser, finer
        if (depth, tuple(j)) in self.leaves:
            return depth
        coarse = (depth - 1, tuple(v >> 1 for v in j))
        if depth > 0 and coarse in self.leaves:
            return depth - 1
        return depth + 1  # finer children exist (2:1 guaranteed)

    # -- refinement / derefinement -----------------------------------------
    def refine(self, keys, balance=True):
        """Refine the given leaves.  With balance=True (nc_limit=1
        semantics, amr/laghos.cpp:653) the 2:1 ripple refines coarse
        neighbours as needed; balance=False refines exactly the given
        leaves, allowing multi-level hanging faces — the semantics of the
        reference's initial Mesh::RefineAtVertex (amr/laghos.cpp:203-208),
        which does not take an nc_limit.  Returns the keys refined."""
        todo = [k for k in keys if k in self.leaves]
        done = set()
        while todo:
            depth, idx = todo.pop()
            key = (depth, idx)
            if key not in self.leaves or depth >= self.max_depth:
                continue
            # 2:1 rule: all face neighbors must exist at depth >= depth
            for d in range(self.dim if balance else 0):
                for side in (-1, 1):
                    nd = self._neighbor_exists_coarser(depth, idx, d, side)
                    if nd is not None and nd < depth:
                        j = list(idx)
                        j[d] += side
                        todo.append(key)
                        todo.append((depth - 1, tuple(v >> 1 for v in j)))
                        break
                else:
                    continue
                break
            else:
                del self.leaves[key]
                for child in np.ndindex(*(2,) * self.dim):
                    child = tuple(reversed(child))
                    cidx = tuple(2 * idx[k] + child[k]
                                 for k in range(self.dim))
                    self.leaves[(depth + 1, cidx)] = 1
                done.add(key)
        self._order = sorted(self.leaves)
        return done

    def balance_violations(self, limit=1):
        """Coarse leaves with a face neighbour more than `limit` levels
        finer.  Refining these (repeatedly, one level per call) restores
        the nc_limit invariant globally — MFEM's LimitNCLevel semantics,
        which GeneralRefinement applies to the whole mesh on every call
        (used by the reference at amr/laghos.cpp:653)."""
        out = set()
        for (kf, fidx) in self.leaves:
            for d in range(self.dim):
                for side in (-1, 1):
                    nidx = list(fidx)
                    nidx[d] += side
                    n_at = self.base_n[d] << kf
                    if nidx[d] < 0 or nidx[d] >= n_at:
                        continue
                    for dl in range(1, kf + 1):
                        cand = (kf - dl, tuple(v >> dl for v in nidx))
                        if cand in self.leaves:
                            if dl > limit:
                                out.add(cand)
                            break
        return sorted(out)

    def derefine(self, keys):
        """Derefine sibling groups whose members are all flagged and
        present, respecting 2:1.  Returns parents created."""
        flagged = set(k for k in keys if k in self.leaves)
        parents = {}
        for (depth, idx) in flagged:
            if depth == 0:
                continue
            parents.setdefault(
                (depth - 1, tuple(v >> 1 for v in idx)), []).append(
                    (depth, idx))
        done = set()
        for parent, kids in parents.items():
            if len(kids) != 2**self.dim:
                continue
            pd, pidx = parent
            # 2:1 safety: no neighbor of any child may be finer than the
            # child (derefining would then create a 2-level jump)
            ok = True
            for (kd, kidx) in kids:
                for d in range(self.dim):
                    for side in (-1, 1):
                        nd = self._neighbor_exists_coarser(kd, kidx, d,
                                                           side)
                        if nd is not None and nd > kd:
                            ok = False
            if not ok:
                continue
            for k in kids:
                del self.leaves[k]
            self.leaves[parent] = 1
            done.add(parent)
        self._order = sorted(self.leaves)
        return done

    # -- discretization structures -----------------------------------------
    def node_ids_int(self, p):
        """Exact integer identification of every leaf node: (NL, nd, 2*dim).

        Per axis a node is encoded as (pos, tag).  Nodes at GLL parameter
        0, 1, or exactly 1/2 (even p) are "corner class": their position
        n/2^e (base-cell units) is dyadic-exact, encoded as
        pos = n * 2^(D+1-e), tag = 0 — so coincident dyadic nodes from
        ANY depths unify.  Interior GLL nodes (irrational parameters) can
        never coincide across different depths or cells (2^δ·g - g' is
        never an integer for GLL parameters g, g' ∈ (0,1) \\ {1/2}), so
        they are encoded by identity: pos = cell origin, tag = depth and
        node index.  A uniform lattice (the previous scheme) is exact
        only for p <= 2 — for p >= 3 it aliases non-coincident GLL nodes
        across depth jumps.
        """
        D = self.max_depth
        d = self.dim
        nd = (p + 1) ** d
        rng = np.arange(p + 1)
        grids = np.meshgrid(*([rng] * d), indexing="ij")
        lat = np.stack([g.reshape(-1, order="F") for g in grids], axis=1)
        out = np.empty((self.num_leaves, nd, 2 * d), dtype=np.int64)
        half = p // 2 if p % 2 == 0 else -1
        for li, (k, idx) in enumerate(self._order):
            for dd in range(d):
                a = lat[:, dd]
                pos = np.empty(nd, dtype=np.int64)
                tag = np.empty(nd, dtype=np.int64)
                corner0 = a == 0
                corner1 = a == p
                mid = a == half
                interior = ~(corner0 | corner1 | mid)
                pos[corner0] = idx[dd] << (D + 1 - k)
                pos[corner1] = (idx[dd] + 1) << (D + 1 - k)
                pos[mid] = (2 * idx[dd] + 1) << (D - k)
                tag[corner0 | corner1 | mid] = 0
                pos[interior] = idx[dd] << (D + 1 - k)
                tag[interior] = k * (p + 1) + a[interior] + 1
                out[li, :, 2 * dd] = pos
                out[li, :, 2 * dd + 1] = tag
        return out

    def node_phys_coords(self, p):
        """Physical (GLL) coordinates of every leaf node: (NL, nd, dim)."""
        gl = gauss_lobatto(p + 1)
        d = self.dim
        nd = (p + 1) ** d
        rng = np.arange(p + 1)
        grids = np.meshgrid(*([rng] * d), indexing="ij")
        lat = np.stack([g.reshape(-1, order="F") for g in grids], axis=1)
        out = np.empty((self.num_leaves, nd, d))
        for li, (k, idx) in enumerate(self._order):
            for dd in range(d):
                cell = self.sizes[dd] / (self.base_n[dd] << k)
                out[li, :, dd] = (idx[dd] + gl[lat[:, dd]]) * cell
        return out

    def build_space(self, p):
        """Global dof numbering + hanging-node constraints.

        Returns a dict with:
          gather (NE, nd): leaf-local lex -> global node id
          coords (Nn, dim): physical node positions (initial box geometry)
          true_ids, slave_ids: partition of nodes
          masters (Ns, W), weights (Ns, W): slave = sum w * true[masters]
              (master indices into the TRUE-dof numbering)
          l_from_t arrays to expand true vectors to the full node set
          ess masks per component
        """
        d = self.dim
        D = self.max_depth
        ids_int = self.node_ids_int(p)
        NE, nd, _ = ids_int.shape
        nn, inverse, first = unify_rows(ids_int.reshape(-1, 2 * d))
        gather = inverse.reshape(NE, nd).astype(np.int32)
        uniq = ids_int.reshape(-1, 2 * d)[first]         # (Nn, 2d) int
        coords = self.node_phys_coords(p).reshape(-1, d)[first]

        # --- hanging constraints ------------------------------------------
        # For every leaf face that borders a coarser neighbor, constrain
        # this leaf's face nodes to the neighbor-face polynomial trace.
        gl = gauss_lobatto(p + 1)
        slave_of: dict[int, tuple] = {}
        leaf_index = {key: i for i, key in enumerate(self._order)}
        rng = np.arange(p + 1)
        grids = np.meshgrid(*([rng] * d), indexing="ij")
        lat = np.stack([g.reshape(-1, order="F") for g in grids], axis=1)

        def find_coarser(k, nidx):
            """Walk up ancestors: the neighbour leaf may be any number
            of levels coarser (non-2:1 meshes).  Returns (leaf, delta)
            or (None, None)."""
            for dl in range(1, k + 1):
                cand = (k - dl, tuple(v >> dl for v in nidx))
                if cand in self.leaves:
                    return cand, dl
            return None, None

        for li, (k, idx) in enumerate(self._order):
            for dd in range(d):
                for side in (0, 1):
                    nidx = list(idx)
                    nidx[dd] += 1 if side else -1
                    n_at = self.base_n[dd] << k
                    if nidx[dd] < 0 or nidx[dd] >= n_at:
                        continue
                    coarse, delta = find_coarser(k, nidx)
                    if delta is None:
                        continue
                    # neighbor is coarser: face nodes of THIS leaf on that
                    # face are slaves of the coarse leaf's face nodes
                    cli = leaf_index[coarse]
                    face_mask = lat[:, dd] == (p if side else 0)
                    face_nodes = np.where(face_mask)[0]
                    # parameter of this leaf's face nodes on the coarse
                    # face: per tangential dim t: coarse param =
                    # (offset + gl)/2 where offset = idx[t] & 1
                    tdims = [t for t in range(d) if t != dd]
                    Ws = []
                    scale = 1 << delta
                    for t in tdims:
                        off = idx[t] & (scale - 1)
                        pts = (off + gl) / scale
                        B, _ = lagrange_tables(gl, pts)
                        Ws.append(B)      # (p+1, p+1): node a -> weights
                    # coarse leaf's face facing back towards us:
                    # if we look in +dd, the coarse face is its dd==0 side
                    cface = 0 if side else p
                    for a in face_nodes:
                        gid = gather[li, a]
                        if gid in slave_of:
                            continue
                        # weights over coarse face nodes
                        wlist = []
                        for t_i, t in enumerate(tdims):
                            wlist.append(Ws[t_i][lat[a, t]])
                        masters = []
                        weights = []
                        for cn in range(nd):
                            if lat[cn, dd] != cface:
                                continue
                            w = 1.0
                            for t_i, t in enumerate(tdims):
                                w *= wlist[t_i][lat[cn, t]]
                            if abs(w) > 1e-14:
                                masters.append(int(gather[cli, cn]))
                                weights.append(float(w))
                        # identity constraint (node coincides with a coarse
                        # node) -> not a slave
                        if (len(masters) == 1 and
                                abs(weights[0] - 1.0) < 1e-12 and
                                masters[0] == gid):
                            continue
                        slave_of[gid] = (masters, weights)

            if d != 3:
                continue
            # --- 3D edge-diagonal constraints ----------------------------
            # A leaf edge can hang on a coarser element that touches it
            # only along that edge (the edge-diagonal neighbor), with no
            # coarser FACE neighbor involved.  Its edge nodes then
            # interpolate the coarse leaf's edge trace (MFEM master/slave
            # edges; the reference relies on this for 3D AMR meshes,
            # amr/README.md rows 3-4).  Edges hanging on a coarser FACE
            # were already slaved by the face scan above (first
            # constraint wins; both are consistent traces).
            for d1 in range(d):
                for d2 in range(d1 + 1, d):
                    t = 3 - d1 - d2           # tangential (edge) dim
                    for s1 in (0, 1):
                        for s2 in (0, 1):
                            nidx = list(idx)
                            nidx[d1] += 1 if s1 else -1
                            nidx[d2] += 1 if s2 else -1
                            if not (0 <= nidx[d1] < self.base_n[d1] << k):
                                continue
                            if not (0 <= nidx[d2] < self.base_n[d2] << k):
                                continue
                            coarse, delta = find_coarser(k, nidx)
                            if delta is None:
                                continue
                            scale = 1 << delta
                            # only a true edge adjacency: our edge must
                            # lie on the coarse leaf's BOUNDARY in both
                            # d1 and d2.  If it is interior in one dim,
                            # the coarse leaf is a face neighbor and the
                            # face scan already constrained these nodes
                            # (against the right trace).
                            on_bdr = True
                            for dd_, ss_ in ((d1, s1), (d2, s2)):
                                plane = idx[dd_] + ss_
                                lo = (nidx[dd_] >> delta) << delta
                                want = lo if ss_ else lo + scale
                                if plane != want:
                                    on_bdr = False
                            if not on_bdr:
                                continue
                            cli = leaf_index[coarse]
                            off = idx[t] & (scale - 1)
                            pts = (off + gl) / scale
                            B, _ = lagrange_tables(gl, pts)
                            c1 = 0 if s1 else p
                            c2 = 0 if s2 else p
                            edge_mask = ((lat[:, d1] == (p if s1 else 0))
                                         & (lat[:, d2] == (p if s2 else 0)))
                            for a in np.where(edge_mask)[0]:
                                gid = gather[li, a]
                                if gid in slave_of:
                                    continue
                                wrow = B[lat[a, t]]
                                masters = []
                                weights = []
                                for cn in range(nd):
                                    if (lat[cn, d1] != c1
                                            or lat[cn, d2] != c2):
                                        continue
                                    w = wrow[lat[cn, t]]
                                    if abs(w) > 1e-14:
                                        masters.append(int(gather[cli, cn]))
                                        weights.append(float(w))
                                if (len(masters) == 1 and
                                        abs(weights[0] - 1.0) < 1e-12 and
                                        masters[0] == gid):
                                    continue
                                slave_of[gid] = (masters, weights)

        slave_ids = np.array(sorted(slave_of), dtype=np.int64)
        is_slave = np.zeros(nn, dtype=bool)
        is_slave[slave_ids] = True
        true_ids = np.where(~is_slave)[0]
        t_of_n = np.full(nn, -1, dtype=np.int64)
        t_of_n[true_ids] = np.arange(true_ids.size)

        # resolve chains: masters that are slaves get substituted (chain
        # depth is bounded by max_depth on non-2:1 meshes)
        for _ in range(self.max_depth + 2):
            changed = False
            for gid, (ms, ws) in list(slave_of.items()):
                if any(is_slave[m] for m in ms):
                    nm, nw = [], []
                    for m, w in zip(ms, ws):
                        if is_slave[m]:
                            m2, w2 = slave_of[m]
                            nm += m2
                            nw += [w * x for x in w2]
                        else:
                            nm.append(m)
                            nw.append(w)
                    # merge duplicates
                    acc = {}
                    for m, w in zip(nm, nw):
                        acc[m] = acc.get(m, 0.0) + w
                    slave_of[gid] = (list(acc), list(acc.values()))
                    changed = True
            if not changed:
                break

        W = max((len(m) for m, _ in slave_of.values()), default=1)
        Ns = slave_ids.size
        masters = np.zeros((Ns, W), dtype=np.int64)
        weights = np.zeros((Ns, W))
        for si, gid in enumerate(slave_ids):
            ms, ws = slave_of[gid]
            masters[si, :len(ms)] = [t_of_n[m] for m in ms]
            weights[si, :len(ws)] = ws

        # essential masks on the box boundary (attrs: fixed-x/y/z).
        # Only corner-class axis codes (tag 0) can sit on the boundary
        # planes; interior GLL parameters are strictly inside the cell.
        maxc = np.array([self.base_n[kk] << (D + 1)
                         for kk in range(d)], dtype=np.int64)
        ess = np.zeros((d, nn), dtype=bool)
        for dd in range(d):
            corner = uniq[:, 2 * dd + 1] == 0
            ess[dd] = corner & ((uniq[:, 2 * dd] == 0)
                                | (uniq[:, 2 * dd] == maxc[dd]))

        return {
            "gather": gather,
            "coords": coords,
            "nn": nn,
            "true_ids": true_ids,
            "slave_ids": slave_ids,
            "masters": masters,
            "weights": weights,
            "t_of_n": t_of_n,
            "ess": ess,
        }
