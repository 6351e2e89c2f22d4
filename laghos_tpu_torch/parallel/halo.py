"""Generic owned-dof halo layout for slab decompositions of an H1 space.

The port's counterpart of `laghos_tpu.parallel.halo`: the owned/ghost
partition of a conforming H1 space's dofs over D contiguous element
slabs, the exchange plan between adjacent slabs, and the global gather
and scatter.  The production paths are `slab_hydro` (lattice planes) and
`chunk_hydro` (a boundary buffer); this layout serves an unstructured
halo build, with the same communication pattern: after each H1 assembly
a rank adds its neighbours' contributions to the dofs it shares with them
(the reference's halo exchange through the prolongation,
laghos_solver.cpp:362-398).

Each rank holds its own unpadded arrays: the JAX layout pads every device
to one shape with a dead slot, which a process per rank does not need.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class HaloLayout:
    """Local numbering and exchange plan of D slabs (host-built)."""

    D: int
    elems: list            # per slab: its global element ids
    gather: list           # per slab: (ne_k, nd) local dof ids
    owned: list            # per slab: (n_k,) float, 1 = owned here
    ess: list              # per slab: (dim, n_k) bool
    loc_of_glob: list      # per slab: (n_k,) global dof id of each local
    send_next: list        # per slab: local ids shared with slab k+1
    send_prev: list        # per slab: local ids shared with slab k-1


def build_layout(space, D: int) -> HaloLayout:
    """Partition the element axis of a conforming H1 space into D slabs
    (ceil(NE / D) elements each, the last one shorter, as the JAX
    layout)."""
    g = np.asarray(space.gather)
    NE, nd = g.shape
    dim = space.mesh.dim
    ne_loc = -(-NE // D)
    ess_g = np.stack([space.ess_mask(c) for c in range(dim)])
    elems = [np.arange(k * ne_loc, min((k + 1) * ne_loc, NE))
             for k in range(D)]
    glob = [np.unique(g[e].reshape(-1)) for e in elems]

    # the exchange plan covers adjacent slabs only: a dof shared by
    # non-adjacent slabs (a slab thinner than one element layer) would be
    # dropped, so refuse
    for k in range(D):
        for j in range(k + 2, D):
            far = np.intersect1d(glob[k], glob[j])
            if far.size:
                raise ValueError(
                    f"halo layout: {far.size} dofs shared between "
                    f"non-adjacent slabs {k} and {j}; slabs must be at "
                    f"least one element layer thick (reduce device count)")

    first_owner = np.full(space.ndof, -1, dtype=np.int64)
    for k in range(D - 1, -1, -1):
        first_owner[glob[k]] = k
    gather, owned, ess = [], [], []
    send_next, send_prev = [], []
    for k in range(D):
        dofs = glob[k]
        gather.append(np.searchsorted(dofs, g[elems[k]]).astype(np.int32))
        owned.append((first_owner[dofs] == k).astype(np.float64))
        ess.append(ess_g[:, dofs])
        nxt = (np.intersect1d(dofs, glob[k + 1]) if k + 1 < D
               else np.zeros(0, np.int64))
        prv = (np.intersect1d(dofs, glob[k - 1]) if k > 0
               else np.zeros(0, np.int64))
        send_next.append(np.searchsorted(dofs, nxt).astype(np.int32))
        send_prev.append(np.searchsorted(dofs, prv).astype(np.int32))
    return HaloLayout(D, elems, gather, owned, ess, glob, send_next,
                      send_prev)


def scatter_global(layout: HaloLayout, u_glob: np.ndarray) -> list:
    """Global (C, ndof) -> per slab local (C, n_k), interface dofs
    replicated."""
    return [np.asarray(u_glob)[:, dofs] for dofs in layout.loc_of_glob]


def gather_global(layout: HaloLayout, u_loc: list, ndof: int):
    """Per slab local (C, n_k) -> global (C, ndof), each dof from its
    owner."""
    C = np.asarray(u_loc[0]).shape[0]
    out = np.zeros((C, ndof))
    for k, dofs in enumerate(layout.loc_of_glob):
        own = layout.owned[k] > 0
        out[:, dofs[own]] = np.asarray(u_loc[k])[:, own]
    return out


def halo_exchange_add(y, layout: HaloLayout, comm):
    """Add the neighbours' contributions to the dofs this rank's slab
    shares with them: y (C, n_k) holds this rank's contributions only.
    Both directions send the ORIGINAL local values, so nothing counts
    twice.  The slab pairs' shared dofs are listed in the same (global id)
    order on both sides."""
    k = comm.rank
    sends = {}
    idx = {}
    for peer, ids in ((k + 1, layout.send_next[k]),
                      (k - 1, layout.send_prev[k])):
        if 0 <= peer < layout.D and ids.size:
            idx[peer] = torch.as_tensor(ids, dtype=torch.long,
                                        device=y.device)
            sends[peer] = y[:, idx[peer]]
    got = comm.exchange(sends)
    y = y.clone()
    for peer in sorted(got):
        y[:, idx[peer]] += got[peer]
    return y
