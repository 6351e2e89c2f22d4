"""Structured (parity-decomposed) E<->L transforms for Cartesian meshes.

The torch counterpart of `laghos_tpu.ops.structured`.  For a Cartesian
n_x x n_y x n_z mesh of order-p tensor elements the H1 dof lattice has
parity structure: element dof blocks span p+1 lattice units while
same-parity neighbours are 2p apart, so splitting elements by
(e_x%2, e_y%2, e_z%2) gives 2^d groups of disjoint blocks.  Each group's
restriction and assembly is then pads and reshapes, with no
data-dependent addressing and no atomics, so the assembly is bitwise
repeatable on the card.

Recognition and renumbering are host NumPy, run once at setup: the mesh
elements are sorted to raster (x-fastest) order and the H1 dofs relabelled
to the raster lattice, after which both permutations are the identity.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class StructMaps:
    """Precomputed maps for structured E<->L transforms."""

    dims: tuple          # (n_x, n_y, n_z) element grid
    p: int               # H1 order
    perm: np.ndarray     # raster lattice id -> topological dof id
    inv: np.ndarray      # topological dof id -> raster lattice id
    e_mesh_at_raster: np.ndarray   # (NE,) mesh element id at raster pos
    e_raster_at_mesh: np.ndarray   # (NE,) raster pos of mesh element

    @property
    def identity_perm(self) -> bool:
        return bool((self.perm == np.arange(self.perm.size)).all())


def renumber_space_to_raster(space, sm: StructMaps) -> StructMaps:
    """Relabel the H1 space's global dofs to the raster lattice order, in
    place, so the struct transforms' permutation becomes the identity.
    Node coordinates, boundary attributes and the gather map move with
    the labels, so everything derived from the space stays consistent;
    only summation orders change.  Returns the updated StructMaps."""
    inv = sm.inv          # old topological id -> raster id == new id
    space.gather = inv[space.gather].astype(np.int32)
    nc = np.empty_like(space.node_coords)
    nc[inv] = space.node_coords
    space.node_coords = nc
    space.bdr_dofs = inv[space.bdr_dofs].astype(np.int64)
    ident = np.arange(space.ndof, dtype=np.int32)
    return StructMaps(dims=sm.dims, p=sm.p, perm=ident, inv=ident,
                      e_mesh_at_raster=sm.e_mesh_at_raster,
                      e_raster_at_mesh=sm.e_raster_at_mesh)


def _raster_positions(mesh):
    """(dims, pos (NE, d), key (NE,)) of a uniform Cartesian mesh, from
    the element centroids; None if the centroids do not form a lattice."""
    d = mesh.dim
    NE = mesh.num_elems
    cent = mesh.verts[mesh.corners_lattice()].mean(axis=1)    # (NE, d)
    lo, hi = mesh.verts.min(axis=0), mesh.verts.max(axis=0)
    dims = tuple(
        np.unique(np.round((cent[:, k] - lo[k]) * 1e10).astype(np.int64)).size
        for k in range(d))
    if int(np.prod(dims)) != NE or (hi <= lo).any():
        return None
    h = (hi - lo) / np.array(dims)
    pos = np.round((cent - lo) / h - 0.5).astype(np.int64)
    if (pos < 0).any() or (pos >= np.array(dims)).any():
        return None
    key = pos[:, 0].copy()
    stride = dims[0]
    for k in range(1, d):
        key = key + pos[:, k] * stride
        stride *= dims[k]
    if np.unique(key).size != NE:
        return None
    return dims, pos, key


def reorder_mesh_elements_to_raster(mesh):
    """If `mesh` is a uniform Cartesian grid, return it with its elements
    sorted in raster (x-fastest) order; else None."""
    found = _raster_positions(mesh)
    if found is None:
        return None
    order = np.argsort(found[2], kind="stable")
    if (order == np.arange(order.size)).all():
        return mesh
    return dataclasses.replace(mesh, elems=mesh.elems[order].copy())


def detect_structure(mesh, gather, p):
    """Recognise `mesh` as a uniform axis-aligned Cartesian grid.

    Returns StructMaps or None: element centroids must form an exact
    lattice, and the gather map must be a bijection between the element
    block lattice ids and the H1 dofs.  A mesh that fails either check
    runs the generic gather path.
    """
    d = mesh.dim
    gather = np.asarray(gather)
    NE, nd = gather.shape
    if nd != (p + 1) ** d or NE != mesh.num_elems:
        return None
    found = _raster_positions(mesh)
    if found is None:
        return None
    dims, pos, key = found
    e_raster_at_mesh = key.astype(np.int32)
    e_mesh_at_raster = np.empty(NE, dtype=np.int32)
    e_mesh_at_raster[key] = np.arange(NE)
    # per-dof lattice id via the gather map (local nodes x-fastest)
    nl = np.stack([g.reshape(-1, order="F") for g in np.meshgrid(
        *([np.arange(p + 1)] * d), indexing="ij")], axis=1)   # (nd, d)
    lat = [dims[k] * p + 1 for k in range(d)]
    ndof = int(gather.max()) + 1
    if ndof != int(np.prod(lat)):
        return None
    glat = np.zeros((NE, nd), dtype=np.int64)
    stride = 1
    for k in range(d):
        glat += (pos[:, k][:, None] * p + nl[None, :, k]) * stride
        stride *= lat[k]
    inv = np.full(ndof, -1, dtype=np.int64)
    inv[gather.reshape(-1)] = glat.reshape(-1)
    if (inv < 0).any() or np.unique(inv).size != ndof:
        return None
    perm = np.empty(ndof, dtype=np.int64)
    perm[inv] = np.arange(ndof)
    return StructMaps(dims=dims, p=p, perm=perm.astype(np.int32),
                      inv=inv.astype(np.int32),
                      e_mesh_at_raster=e_mesh_at_raster,
                      e_raster_at_mesh=e_raster_at_mesh)


def _nb(n, q):
    """Number of elements with index parity q along an axis of n."""
    return (n - 1 - q) // 2 + 1 if n - 1 >= q else 0


def _windows(v, n, p):
    """(..., L=np+1) -> (..., n, p+1) overlapping element windows.

    Window e starts at lattice e*p.  Same-parity windows are 2p apart
    (disjoint for p >= 1), so each parity class is a pad + reshape; the
    parities interleave back by a stack + reshape."""
    parts = {}
    nbs = {}
    for q in (0, 1):
        nb = _nb(n, q)
        nbs[q] = nb
        if nb == 0:
            continue
        start = q * p
        need = start + nb * 2 * p
        w = F.pad(v, (0, max(0, need - v.shape[-1])))
        w = w[..., start:start + nb * 2 * p]
        parts[q] = w.reshape(v.shape[:-1] + (nb, 2 * p))[..., :p + 1]
    if 1 not in parts:
        return parts[0]
    p0, p1 = parts[0], parts[1]
    if nbs[1] < nbs[0]:        # odd n: pad the shorter parity by one row
        p1 = F.pad(p1, (0, 0, 0, 1))
    out = torch.stack([p0, p1], dim=-2)        # (..., nb0, 2, p+1)
    out = out.reshape(v.shape[:-1] + (2 * nbs[0], p + 1))
    return out[..., :n, :]


def _windows_t(w, n, p):
    """Transpose of _windows: (..., n, p+1) -> (..., np+1) with adds."""
    L = n * p + 1
    nb0, nb1 = _nb(n, 0), _nb(n, 1)
    wp = F.pad(w, (0, 0, 0, 1)) if n % 2 == 1 else w
    wp = wp.reshape(w.shape[:-2] + (nb0, 2, p + 1))
    parts = {0: wp[..., 0, :], 1: wp[..., 1, :][..., :nb1, :]}
    acc = None
    for q in (0, 1):
        nb = _nb(n, q)
        if nb == 0:
            continue
        v = F.pad(parts[q], (0, p - 1))                       # (..., nb, 2p)
        v = v.reshape(v.shape[:-2] + (nb * 2 * p,))
        start = q * p
        full = F.pad(v, (start, (L + 2 * p) - (start + nb * 2 * p)))
        full = full[..., :L]
        acc = full if acc is None else acc + full
    return acc


def l_to_e_struct(u_l, sm: StructMaps):
    """L-vector (..., ndof) -> E-vector (..., NE, (p+1)^d), mesh order."""
    p, d = sm.p, len(sm.dims)
    lat = [n * p + 1 for n in sm.dims]
    lead = tuple(u_l.shape[:-1])
    nl = len(lead)
    u = u_l if sm.identity_perm else u_l[..., _index(sm.perm, u_l)]
    u = u.reshape(lead + tuple(lat[::-1]))
    # axes after lead: (z, y, x).  Step k consumes lattice axis k (x
    # first) and appends (n_k, p+1) at the end.
    for k in range(d):
        u = torch.movedim(u, nl + (d - 1 - k), -1)
        u = _windows(u, sm.dims[k], p)
    # lead + (n_x, l_x, n_y, l_y, n_z, l_z) ->
    # lead + (n_z..n_x, l_z..l_x), both x-fastest on flatten
    permax = (tuple(range(nl))
              + tuple(nl + 2 * (d - 1 - k) for k in range(d))
              + tuple(nl + 2 * (d - 1 - k) + 1 for k in range(d)))
    u = u.permute(permax)
    ne = int(np.prod(sm.dims))
    u = u.reshape(lead + (ne, (p + 1) ** d))
    if (sm.e_raster_at_mesh == np.arange(ne)).all():
        return u
    return u.index_select(-2, _index(sm.e_raster_at_mesh, u))


def e_to_l_struct(u_e, sm: StructMaps):
    """E-vector (..., NE, (p+1)^d) -> assembled L-vector (..., ndof)."""
    p, d = sm.p, len(sm.dims)
    lead = tuple(u_e.shape[:-2])
    nl = len(lead)
    ne = int(np.prod(sm.dims))
    u = u_e
    if not (sm.e_mesh_at_raster == np.arange(ne)).all():
        u = u.index_select(-2, _index(sm.e_mesh_at_raster, u))
    u = u.reshape(lead + tuple(sm.dims[::-1]) + (p + 1,) * d)
    # lead + (n_z, n_y, n_x, l_z, l_y, l_x) -> interleave to
    # lead + (n_x, l_x, n_y, l_y, n_z, l_z)
    permax = tuple(range(nl)) + sum(
        ((nl + (d - 1 - k), nl + d + (d - 1 - k)) for k in range(d)), ())
    u = u.permute(permax)
    # step k (reverse order: z first) consumes the trailing (n_k, l_k)
    # pair and re-inserts the merged lattice axis at its home position
    for k in reversed(range(d)):
        u = _windows_t(u, sm.dims[k], p)
        u = torch.movedim(u, -1, nl + (d - 1 - k))
    out = u.reshape(lead + (int(np.prod([n * p + 1 for n in sm.dims])),))
    return out if sm.identity_perm else out[..., _index(sm.inv, out)]


def _index(a, like):
    return torch.as_tensor(a, dtype=torch.long, device=like.device)
