"""Finite-element spaces: global dof numbering, gather maps, boundary masks.

H1 continuous Gauss-Lobatto spaces with lexicographic element dof maps
(ElementRestriction with ElementDofOrdering::LEXICOGRAPHIC,
laghos_assembly.cpp:133-134) and per-component essential dof masks from
boundary attributes (laghos.cpp:499-515).  The L2 Bernstein space is
element-local and needs no numbering.

Global H1 numbering is built topologically: every element node at uniform
reference lattice coordinates (i/p, j/p, k/p) is identified across elements
by its exact multilinear vertex-weight signature, an integer key that is
identical from every element sharing the containing vertex/edge/face.  The
numbering is the one `laghos_tpu.fem.space` produces, so gather maps and
masks agree bitwise.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .mesh import Mesh, unify_rows
from .quadrature import gauss_lobatto


def _lattice_multi_index(p: int, dim: int) -> np.ndarray:
    """(nd, dim) local lattice coordinates, x fastest (lexicographic)."""
    rng = np.arange(p + 1)
    grids = np.meshgrid(*([rng] * dim), indexing="ij")
    return np.stack([g.reshape(-1, order="F") for g in grids], axis=1)


@dataclasses.dataclass
class H1Space:
    """Scalar continuous H1 space of order p on a tensor-product mesh."""

    mesh: Mesh
    p: int
    ndof: int                 # number of global scalar dofs
    gather: np.ndarray        # (NE, (p+1)^dim) int32: local lex -> global
    node_coords: np.ndarray   # (ndof, dim) positions of the GLobatto nodes
    dof_attrs: list           # per-dof set of boundary attrs it lies on

    def ess_mask(self, component: int) -> np.ndarray:
        """True where velocity component `component` is constrained.

        Boundary attribute d+1 fixes component d (laghos.cpp:499-515).
        """
        attr = component + 1
        return np.array([attr in a for a in self.dof_attrs], dtype=bool)


def build_h1_space(mesh: Mesh, p: int) -> H1Space:
    d = mesh.dim
    NE = mesh.num_elems
    nd = (p + 1) ** d
    lat = _lattice_multi_index(p, d)              # (nd, d)
    corners = mesh.corners_lattice()              # (NE, 2^d) vertex ids

    # Integer multilinear weights of each corner at each local node:
    # w_corner = prod_d (p - i_d) if corner bit 0 else i_d.
    ncor = 2**d
    weights = np.ones((nd, ncor), dtype=np.int64)
    for dd in range(d):
        i = lat[:, dd][:, None]                   # (nd, 1)
        bit = (np.arange(ncor) >> dd) & 1         # (ncor,)
        weights *= np.where(bit[None, :] == 0, p - i, i)

    # Key per (element, node): sorted list of (vertex, weight) with weight>0,
    # padded with (-1, 0).
    vert = corners[:, None, :].repeat(nd, axis=1).astype(np.int64)  # (NE,nd,c)
    wts = np.broadcast_to(weights[None], (NE, nd, ncor)).copy()
    vert = vert.copy()
    vert[wts == 0] = -1
    wts[vert == -1] = 0
    # sort pairs by (vertex, weight)
    order = np.lexsort((wts.reshape(-1, ncor), vert.reshape(-1, ncor)),
                       axis=-1)
    flatv = np.take_along_axis(vert.reshape(-1, ncor), order, axis=-1)
    flatw = np.take_along_axis(wts.reshape(-1, ncor), order, axis=-1)
    keys = np.concatenate([flatv, flatw], axis=1)  # (NE*nd, 2*ncor)

    ndof, inverse, first_row = unify_rows(keys)
    uniq = keys[first_row]
    gather = inverse.reshape(NE, nd).astype(np.int32)

    # Node coordinates: multilinear geometry map at the Gauss-Lobatto points.
    gl = gauss_lobatto(p + 1)
    cs = mesh.verts[corners]                      # (NE, 2^d, dim)
    shape_w = np.ones((nd, ncor))
    for dd in range(d):
        t = gl[lat[:, dd]][:, None]               # (nd, 1)
        bit = (np.arange(ncor) >> dd) & 1
        shape_w *= np.where(bit[None, :] == 0, 1.0 - t, t)
    epos = np.einsum("nc,ecd->end", shape_w, cs)  # (NE, nd, dim)
    # first-writer-wins deterministic assignment (writing in reverse order
    # leaves the first occurrence in place)
    flat_g = gather.reshape(-1)
    flat_p = epos.reshape(-1, d)
    first = np.zeros(ndof, dtype=np.int64)
    first[flat_g[::-1]] = np.arange(flat_g.size - 1, -1, -1)
    node_coords = flat_p[first]

    # Boundary attributes per dof: a dof lies on a boundary face iff its
    # vertex support is a subset of the face's vertex set.
    vert_faces: dict[int, list[int]] = {}
    face_sets = []
    for b in range(mesh.bdr_verts.shape[0]):
        fs = frozenset(int(v) for v in mesh.bdr_verts[b])
        face_sets.append(fs)
        for v in fs:
            vert_faces.setdefault(v, []).append(b)
    dof_attrs: list[set] = [set() for _ in range(ndof)]
    supp_v = uniq[:, :ncor]
    for g in range(ndof):
        verts_g = [int(v) for v in supp_v[g] if v >= 0]
        cand = vert_faces.get(verts_g[0], [])
        for b in cand:
            if all(v in face_sets[b] for v in verts_g):
                dof_attrs[g].add(int(mesh.bdr_attr[b]))

    return H1Space(mesh, p, ndof, gather, node_coords, dof_attrs)
