"""Simplex meshes: triangles and tetrahedra, their readers, uniform
refinement and H1 numbering.

Complements fem/mesh.py (tensor elements) with the simplex capability the
reference gets from MFEM for files like data/square01_tri.mesh.  Node
identification uses exact integer barycentric-weight keys: the node at
barycentric (i, j, k)/p of a triangle with vertices (a, b, c) has key
{(a,i), (b,j), (c,k)} (zero weights dropped), identical from both sides of
any shared edge regardless of orientation.  Host NumPy; the same meshes and
numbering as `laghos_tpu.fem.simplex_mesh`.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from . import mesh as fmesh
from .mesh import unify_rows
from .simplex import _bary_lattice, _bary_lattice_tet


@dataclasses.dataclass
class TriMesh:
    verts: np.ndarray      # (nv, 2)
    elems: np.ndarray      # (NE, 3) vertex ids
    bdr_verts: np.ndarray  # (NB, 2)
    bdr_attr: np.ndarray   # (NB,)
    dim: int = 2

    @property
    def num_elems(self):
        return self.elems.shape[0]

    def element_volumes(self):
        a = self.verts[self.elems[:, 0]]
        b = self.verts[self.elems[:, 1]]
        c = self.verts[self.elems[:, 2]]
        return 0.5 * np.abs(
            (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1])
            - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0]))


def load_tri_mesh(path: str) -> TriMesh:
    """MFEM v1.0 reader for triangle meshes (same token grammar as
    mesh.load_mfem_mesh)."""
    with open(path) as f:
        tokens = []
        for line in f:
            line = line.split("#")[0].strip()
            if line:
                tokens.extend(line.split())
    it = iter(tokens)
    dim = None
    elems, bdr = [], []
    verts = None
    nv = 0
    nodes_vals = None
    vdim = None
    while True:
        try:
            tok = next(it)
        except StopIteration:
            break
        if tok == "dimension":
            dim = int(next(it))
        elif tok == "elements":
            ne = int(next(it))
            for _ in range(ne):
                attr = int(next(it))
                geom = int(next(it))
                assert geom == fmesh.TRIANGLE, "triangle mesh expected"
                elems.append([int(next(it)) for _ in range(3)])
        elif tok == "boundary":
            nb = int(next(it))
            for _ in range(nb):
                attr = int(next(it))
                geom = int(next(it))
                bdr.append((attr, [int(next(it)) for _ in range(2)]))
        elif tok == "vertices":
            nv = int(next(it))
            tok2 = next(it)
            if tok2 == "nodes":
                rest = list(it)
                vals = []
                i = 0
                while i < len(rest):
                    t = rest[i]
                    if t in ("FiniteElementSpace",):
                        i += 1
                    elif t.startswith("FiniteElementCollection"):
                        i += 2
                    elif t.startswith("VDim"):
                        vdim = int(rest[i + 1])
                        i += 2
                    elif t.startswith("Ordering"):
                        i += 2
                    else:
                        vals.append(float(t))
                        i += 1
                nodes_vals = np.array(vals)
                break
            else:
                vdim = int(tok2)
                vals = [float(next(it)) for _ in range(nv * vdim)]
                verts = np.array(vals).reshape(nv, vdim)
    if verts is None:
        verts = nodes_vals.reshape(vdim, nv).T
    return TriMesh(
        verts[:, :2].astype(np.float64),
        np.array(elems, dtype=np.int32),
        np.array([v for (_, v) in bdr], dtype=np.int32),
        np.array([a for (a, _) in bdr], dtype=np.int32),
    )


def make_tri_mesh(n, sizes=(1.0, 1.0), origin=(0.0, 0.0)) -> TriMesh:
    """Cartesian rectangle split into triangles (2 per cell along the
    low-low/high-high diagonal).  Boundary attrs follow the fixed-x/y =
    1/2 convention of the reference meshes (e.g. data/rt2D.mesh), which
    build_tri_h1 turns into per-component v.n = 0 masks."""
    n = tuple(int(v) for v in n)
    sizes = tuple(float(s) for s in sizes)
    shape = (n[0] + 1, n[1] + 1)
    ax = [np.linspace(origin[d], origin[d] + sizes[d], shape[d])
          for d in range(2)]
    G = np.meshgrid(*ax, indexing="ij")
    verts = np.stack([g.reshape(-1) for g in G], axis=1)

    def vid(ix, iy):
        return ix * shape[1] + iy

    elems = []
    for ix in range(n[0]):
        for iy in range(n[1]):
            a, b = vid(ix, iy), vid(ix + 1, iy)
            c, d = vid(ix + 1, iy + 1), vid(ix, iy + 1)
            elems.append([a, b, c])
            elems.append([a, c, d])
    bdr, attr = [], []
    for iy in range(n[1]):                     # x = const edges: attr 1
        bdr.append([vid(0, iy), vid(0, iy + 1)])
        bdr.append([vid(n[0], iy), vid(n[0], iy + 1)])
        attr.extend([1, 1])
    for ix in range(n[0]):                     # y = const edges: attr 2
        bdr.append([vid(ix, 0), vid(ix + 1, 0)])
        bdr.append([vid(ix, n[1]), vid(ix + 1, n[1])])
        attr.extend([2, 2])
    return TriMesh(verts, np.array(elems, dtype=np.int32),
                   np.array(bdr, dtype=np.int32),
                   np.array(attr, dtype=np.int32))


def uniform_refine_tri(m: TriMesh) -> TriMesh:
    """1:4 red refinement via edge midpoints."""
    NE = m.num_elems
    e = m.elems.astype(np.int64)
    # midpoint keys: sorted vertex pairs; corners: (v, v)
    pairs = np.stack([
        np.sort(np.stack([e[:, 0], e[:, 1]], 1), 1),
        np.sort(np.stack([e[:, 1], e[:, 2]], 1), 1),
        np.sort(np.stack([e[:, 0], e[:, 2]], 1), 1),
    ], axis=1)                                   # (NE, 3, 2)
    corners = np.stack([e, e], axis=-1)          # (NE, 3, 2)
    rows = np.concatenate([corners, pairs], axis=1).reshape(-1, 2)
    brows = np.concatenate([
        np.stack([m.bdr_verts, m.bdr_verts], -1).reshape(-1, 2),
        np.sort(m.bdr_verts, axis=1)], axis=0).astype(np.int64)
    allrows = np.concatenate([rows, brows])
    nnew, inverse, first = unify_rows(allrows)
    coords = m.verts[allrows[:, 0]] * 0.5 + m.verts[allrows[:, 1]] * 0.5
    new_verts = coords[first]
    ids = inverse[:NE * 6].reshape(NE, 6)        # v0 v1 v2 m01 m12 m02
    v0, v1, v2, m01, m12, m02 = [ids[:, k] for k in range(6)]
    children = np.stack([
        np.stack([v0, m01, m02], 1),
        np.stack([m01, v1, m12], 1),
        np.stack([m02, m12, v2], 1),
        np.stack([m01, m12, m02], 1),
    ], axis=1).reshape(NE * 4, 3)
    nb = m.bdr_verts.shape[0]
    bc = inverse[NE * 6:NE * 6 + 2 * nb].reshape(nb, 2)  # endpoint ids
    bm = inverse[NE * 6 + 2 * nb:]                       # midpoint ids
    new_bdr = np.concatenate([
        np.stack([bc[:, 0], bm], 1), np.stack([bm, bc[:, 1]], 1)])
    new_attr = np.concatenate([m.bdr_attr, m.bdr_attr])
    return TriMesh(new_verts, children.astype(np.int32),
                   new_bdr.astype(np.int32), new_attr.astype(np.int32))


def build_tri_h1(m: TriMesh, p: int):
    """Global H1 numbering + ess masks for P_p on triangles."""
    lat = _bary_lattice(p)                       # (nd, 3)
    NE = m.num_elems
    nd = lat.shape[0]
    vert = m.elems[:, None, :].repeat(nd, axis=1).astype(np.int64)
    wts = np.broadcast_to(lat[None], (NE, nd, 3)).astype(np.int64).copy()
    vert = vert.copy()
    vert[wts == 0] = -1
    w2 = wts.copy()
    w2[vert == -1] = 0
    order = np.lexsort((w2.reshape(-1, 3), vert.reshape(-1, 3)), axis=-1)
    fv = np.take_along_axis(vert.reshape(-1, 3), order, axis=-1)
    fw = np.take_along_axis(w2.reshape(-1, 3), order, axis=-1)
    keys = np.concatenate([fv, fw], axis=1)
    ndof, inverse, first = unify_rows(keys)
    gather = inverse.reshape(NE, nd).astype(np.int32)
    # node coords: barycentric combination of vertices
    bw = lat.astype(np.float64) / p
    epos = np.einsum("nc,ecd->end", bw, m.verts[m.elems])
    flat_g = gather.reshape(-1)
    firstidx = np.zeros(ndof, dtype=np.int64)
    firstidx[flat_g[::-1]] = np.arange(flat_g.size - 1, -1, -1)
    node_coords = epos.reshape(-1, 2)[firstidx]

    # boundary attrs per dof
    uniq = keys[first]
    supp_v = uniq[:, :3]
    vert_faces: dict = {}
    face_sets = []
    for b in range(m.bdr_verts.shape[0]):
        fs = frozenset(int(v) for v in m.bdr_verts[b])
        face_sets.append(fs)
        for v in fs:
            vert_faces.setdefault(v, []).append(b)
    ess = np.zeros((2, ndof), dtype=bool)
    for g in range(ndof):
        vs = [int(v) for v in supp_v[g] if v >= 0]
        for b in vert_faces.get(vs[0], []):
            if all(v in face_sets[b] for v in vs):
                attr = int(m.bdr_attr[b])
                if 1 <= attr <= 2:
                    ess[attr - 1, g] = True
    return {"gather": gather, "ndof": ndof, "coords": node_coords,
            "ess": ess}


# ---------------------------------------------------------------------------
# Tetrahedral meshes (3D simplices).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TetMesh:
    verts: np.ndarray      # (nv, 3)
    elems: np.ndarray      # (NE, 4) vertex ids
    bdr_verts: np.ndarray  # (NB, 3) boundary triangles
    bdr_attr: np.ndarray   # (NB,)
    dim: int = 3

    @property
    def num_elems(self):
        return self.elems.shape[0]

    def element_volumes(self):
        v = self.verts[self.elems]                    # (NE, 4, 3)
        e = v[:, 1:] - v[:, :1]                       # (NE, 3, 3)
        return np.abs(np.linalg.det(e)) / 6.0


def _orient_tets(verts, elems):
    """Swap two vertices of any tet whose element map has det(J) < 0.

    The map pairs barycentric weights (x, y, z, 1-x-y-z) with vertex
    columns (V0, V1, V2, V3) — the convention of build_tet_h1 /
    h1_tet_tables — so J's columns are V0-V3, V1-V3, V2-V3."""
    v = verts[elems]
    d = np.linalg.det(np.stack(
        [v[:, 0] - v[:, 3], v[:, 1] - v[:, 3], v[:, 2] - v[:, 3]],
        axis=-1))
    flip = d < 0
    out = elems.copy()
    out[flip, 2], out[flip, 3] = elems[flip, 3], elems[flip, 2]
    return out


def make_tet_mesh(n, sizes=(1.0, 1.0, 1.0)) -> TetMesh:
    """Kuhn (Freudenthal) triangulation of a Cartesian box: each cell
    splits into the 6 tets of the axis-permutation paths from the low to
    the high corner.  Face diagonals are defined in global axes, so the
    triangulation is conforming across cells.  Boundary attrs follow the
    fixed-x/y/z = 1/2/3 convention (laghos.cpp:1499-1525)."""
    n = tuple(int(v) for v in n)
    sizes = tuple(float(s) for s in sizes)
    shape = tuple(v + 1 for v in n)
    ax = [np.linspace(0.0, sizes[d], shape[d]) for d in range(3)]
    G = np.meshgrid(*ax, indexing="ij")
    verts = np.stack([g.reshape(-1) for g in G], axis=1)

    def vid(ix, iy, iz):
        return (ix * shape[1] + iy) * shape[2] + iz

    elems = []
    for (ix, iy, iz) in np.ndindex(*n):
        base = np.array([ix, iy, iz])
        for perm in itertools.permutations(range(3)):
            path = [base.copy()]
            for d in perm:
                nxt = path[-1].copy()
                nxt[d] += 1
                path.append(nxt)
            elems.append([vid(*p) for p in path])
    elems = _orient_tets(verts, np.array(elems, dtype=np.int64))

    # boundary: each box face quad -> 2 triangles split along the
    # global-axes diagonal (the same diagonal the Kuhn tets expose)
    bdr, attr = [], []
    for d in range(3):
        a, b = [k for k in range(3) if k != d]
        for side in (0, n[d]):
            for ia in range(n[a]):
                for ib in range(n[b]):
                    c = [0, 0, 0]
                    c[d] = side

                    def q(da, db):
                        cc = list(c)
                        cc[a] = ia + da
                        cc[b] = ib + db
                        return vid(*cc)

                    # diagonal q(0,0)-q(1,1) (both-low to both-high):
                    # matches the Kuhn face cut
                    bdr.append([q(0, 0), q(1, 0), q(1, 1)])
                    bdr.append([q(0, 0), q(1, 1), q(0, 1)])
                    attr.extend([d + 1, d + 1])
    return TetMesh(verts, elems.astype(np.int32),
                   np.array(bdr, dtype=np.int32),
                   np.array(attr, dtype=np.int32))


def load_tet_mesh(path: str) -> TetMesh:
    """MFEM v1.0 reader for tetrahedral meshes."""
    with open(path) as f:
        tokens = []
        for line in f:
            line = line.split("#")[0].strip()
            if line:
                tokens.extend(line.split())
    it = iter(tokens)
    elems, bdr = [], []
    verts = None
    while True:
        try:
            tok = next(it)
        except StopIteration:
            break
        if tok == "elements":
            for _ in range(int(next(it))):
                _attr = int(next(it))
                geom = int(next(it))
                assert geom == fmesh.TETRAHEDRON, "tet mesh expected"
                elems.append([int(next(it)) for _ in range(4)])
        elif tok == "boundary":
            for _ in range(int(next(it))):
                attr = int(next(it))
                geom = int(next(it))
                assert geom == fmesh.TRIANGLE
                bdr.append((attr, [int(next(it)) for _ in range(3)]))
        elif tok == "vertices":
            nv = int(next(it))
            vdim = int(next(it))
            vals = [float(next(it)) for _ in range(nv * vdim)]
            verts = np.array(vals).reshape(nv, vdim)
    e = _orient_tets(verts, np.array(elems, dtype=np.int64))
    return TetMesh(
        verts[:, :3].astype(np.float64), e.astype(np.int32),
        np.array([v for (_, v) in bdr], dtype=np.int32),
        np.array([a for (a, _) in bdr], dtype=np.int32))


def uniform_refine_tet(m: TetMesh) -> TetMesh:
    """1:8 red (Bey) refinement via edge midpoints: 4 corner tets plus the
    interior octahedron split along the m02-m13 diagonal."""
    NE = m.num_elems
    e = m.elems.astype(np.int64)
    # the 6 edges of a tet, as sorted vertex pairs
    EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    pairs = np.stack([np.sort(np.stack([e[:, i], e[:, j]], 1), 1)
                      for (i, j) in EDGES], axis=1)       # (NE, 6, 2)
    corners = np.stack([e, e], axis=-1)                   # (NE, 4, 2)
    rows = np.concatenate([corners, pairs], axis=1).reshape(-1, 2)
    # boundary triangles refine 1:4 with their 3 edge midpoints
    bt = m.bdr_verts.astype(np.int64)
    bpairs = np.stack([
        np.sort(np.stack([bt[:, 0], bt[:, 1]], 1), 1),
        np.sort(np.stack([bt[:, 1], bt[:, 2]], 1), 1),
        np.sort(np.stack([bt[:, 0], bt[:, 2]], 1), 1)], axis=1)
    bcorn = np.stack([bt, bt], axis=-1)                   # (NB, 3, 2)
    brows = np.concatenate([bcorn, bpairs], axis=1).reshape(-1, 2)
    allrows = np.concatenate([rows, brows])
    nnew, inverse, first = unify_rows(allrows)
    coords = 0.5 * (m.verts[allrows[:, 0]] + m.verts[allrows[:, 1]])
    new_verts = coords[first]
    ids = inverse[:NE * 10].reshape(NE, 10)
    v0, v1, v2, v3 = [ids[:, k] for k in range(4)]
    m01, m02, m03, m12, m13, m23 = [ids[:, 4 + k] for k in range(6)]
    children = np.stack([
        np.stack([v0, m01, m02, m03], 1),
        np.stack([m01, v1, m12, m13], 1),
        np.stack([m02, m12, v2, m23], 1),
        np.stack([m03, m13, m23, v3], 1),
        # octahedron, diagonal m02-m13 (Bey's rule)
        np.stack([m01, m02, m03, m13], 1),
        np.stack([m01, m02, m12, m13], 1),
        np.stack([m02, m03, m13, m23], 1),
        np.stack([m02, m12, m13, m23], 1),
    ], axis=1).reshape(NE * 8, 4)
    children = _orient_tets(new_verts, children)
    nb = bt.shape[0]
    bids = inverse[NE * 10:].reshape(nb, 6)
    b0, b1, b2 = [bids[:, k] for k in range(3)]
    n01, n12, n02 = [bids[:, 3 + k] for k in range(3)]
    new_bdr = np.concatenate([
        np.stack([b0, n01, n02], 1), np.stack([n01, b1, n12], 1),
        np.stack([n02, n12, b2], 1), np.stack([n01, n12, n02], 1)])
    new_attr = np.concatenate([m.bdr_attr] * 4)
    return TetMesh(new_verts, children.astype(np.int32),
                   new_bdr.astype(np.int32), new_attr.astype(np.int32))


def build_tet_h1(m: TetMesh, p: int):
    """Global H1 numbering + ess masks for P_p on tets (the 4-barycentric
    analog of build_tri_h1; same integer-weight key identification)."""
    lat = _bary_lattice_tet(p)                   # (nd, 4)
    NE = m.num_elems
    nd = lat.shape[0]
    vert = m.elems[:, None, :].repeat(nd, axis=1).astype(np.int64).copy()
    wts = np.broadcast_to(lat[None], (NE, nd, 4)).astype(np.int64).copy()
    vert[wts == 0] = -1
    w2 = wts.copy()
    w2[vert == -1] = 0
    order = np.lexsort((w2.reshape(-1, 4), vert.reshape(-1, 4)), axis=-1)
    fv = np.take_along_axis(vert.reshape(-1, 4), order, axis=-1)
    fw = np.take_along_axis(w2.reshape(-1, 4), order, axis=-1)
    keys = np.concatenate([fv, fw], axis=1)
    ndof, inverse, first = unify_rows(keys)
    gather = inverse.reshape(NE, nd).astype(np.int32)
    bw = lat.astype(np.float64) / p
    epos = np.einsum("nc,ecd->end", bw, m.verts[m.elems])
    flat_g = gather.reshape(-1)
    firstidx = np.zeros(ndof, dtype=np.int64)
    firstidx[flat_g[::-1]] = np.arange(flat_g.size - 1, -1, -1)
    node_coords = epos.reshape(-1, 3)[firstidx]

    uniq = keys[first]
    supp_v = uniq[:, :4]
    vert_faces: dict = {}
    face_sets = []
    for b in range(m.bdr_verts.shape[0]):
        fs = frozenset(int(v) for v in m.bdr_verts[b])
        face_sets.append(fs)
        for v in fs:
            vert_faces.setdefault(v, []).append(b)
    ess = np.zeros((3, ndof), dtype=bool)
    for g in range(ndof):
        vs = [int(v) for v in supp_v[g] if v >= 0]
        for b in vert_faces.get(vs[0], []):
            if all(v in face_sets[b] for v in vs):
                attr = int(m.bdr_attr[b])
                if 1 <= attr <= 3:
                    ess[attr - 1, g] = True
    return {"gather": gather, "ndof": ndof, "coords": node_coords,
            "ess": ess}


def load_simplex_mesh(path: str):
    """Dispatch an MFEM v1.0 simplex mesh file to the triangle or tet
    reader by its (single) element geometry."""
    with open(path) as f:
        tokens = []
        for line in f:
            line = line.split("#")[0].strip()
            if line:
                tokens.extend(line.split())
    try:
        k = tokens.index("elements")
        geom = int(tokens[k + 3])    # count, attr, geom
    except (ValueError, IndexError):
        raise ValueError(f"not an MFEM v1.0 mesh: {path}")
    if geom == fmesh.TETRAHEDRON:
        return load_tet_mesh(path)
    return load_tri_mesh(path)
