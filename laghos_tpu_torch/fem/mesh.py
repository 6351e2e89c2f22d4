"""Meshes: Cartesian generators, mesh-file readers, uniform refinement.

Covers the mesh capabilities the reference consumes from MFEM:
MakeCartesian1D/2D/3D (laghos.cpp:428-445), LoadFromFile (laghos.cpp:390;
MFEM v1.0 and NetGen areamesh2 files), UniformRefinement
(laghos.cpp:391,446-449), and the boundary-attribute convention
attr 1/2/3 = fixed-x/y/z (laghos.cpp:1476-1525).

Segments, quads and hexes; a simplex file raises SimplexMeshError, and
fem/simplex_mesh.py reads it (data.get_mesh falls back to it).  The mesh is
a purely host-side (NumPy) object: after setup, positions live as a torch
dof tensor and the topology only survives as gather index maps.  Same
numbering as `laghos_tpu.fem.mesh`, so gather maps agree bitwise.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# MFEM geometry ids (mesh/geom.hpp)
SEGMENT, TRIANGLE, SQUARE, TETRAHEDRON, CUBE = 1, 2, 3, 4, 5

# Map the 2^dim lattice corners (x fastest) to MFEM's vertex ordering.
# quad: CCW (0,0),(1,0),(1,1),(0,1); hex: bottom CCW then top CCW.
_CORNER_TO_MFEM = {
    1: [0, 1],
    2: [0, 1, 3, 2],        # lattice (0,0),(1,0),(0,1),(1,1) -> mfem 0,1,3,2
    3: [0, 1, 3, 2, 4, 5, 7, 6],
}
# Inverse: mfem vertex j sits at lattice corner _MFEM_TO_CORNER[dim][j].
_MFEM_TO_CORNER = {d: np.argsort(v) for d, v in _CORNER_TO_MFEM.items()}


@dataclasses.dataclass
class Mesh:
    """A conforming mesh of a single tensor-product element type."""

    dim: int
    verts: np.ndarray      # (nv, dim) float64 vertex coordinates
    elems: np.ndarray      # (NE, 2**dim) int32, MFEM vertex ordering
    bdr_verts: np.ndarray  # (NB, 2**(dim-1)) int32
    bdr_attr: np.ndarray   # (NB,) int32

    @property
    def num_elems(self) -> int:
        return self.elems.shape[0]

    @property
    def num_verts(self) -> int:
        return self.verts.shape[0]

    def corners_lattice(self) -> np.ndarray:
        """Element corner vertex ids in lattice order (x fastest)."""
        return self.elems[:, _CORNER_TO_MFEM[self.dim]]


class SimplexMeshError(NotImplementedError):
    """`load_mfem_mesh` was given a triangle or tetrahedron mesh."""


def _packed_columns(keys: np.ndarray) -> np.ndarray:
    """The rows of `keys` with runs of adjacent columns packed into one
    int64 each (mixed radix over the columns' ranges, the first the most
    significant, every packed value below 2^62): the same lexicographic
    order of rows and the same equal rows on fewer columns, for a faster
    sort."""
    lo, hi = keys.min(axis=0), keys.max(axis=0)
    span = [int(h) - int(l) + 1 for l, h in zip(lo, hi)]
    cols, j = [], 0
    while j < keys.shape[1]:
        if span[j] >= 2**62:            # as it is: no room to shift it
            cols.append(keys[:, j])
            j += 1
            continue
        k, width = j + 1, span[j]
        while k < keys.shape[1] and width * span[k] < 2**62:
            width *= span[k]
            k += 1
        col = keys[:, j] - lo[j]
        for m in range(j + 1, k):
            col = col * span[m] + (keys[:, m] - lo[m])
        cols.append(col)
        j = k
    return np.stack(cols, axis=1)


def unify_rows(keys: np.ndarray):
    """Deduplicate rows of an int64 matrix.

    Returns (nunique, inverse int32 (nrows,), first int64 (nunique,)):
    unique ids in lexicographic row order, `first` the first original row
    of each unique id.
    """
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    if keys.shape[0] == 0:
        return 0, np.zeros(0, np.int32), np.zeros(0, np.int64)
    keys = _packed_columns(keys)
    # a stable sort on the columns, the first the primary key: the row
    # order and first occurrences of np.unique(axis=0), without its
    # comparisons of whole rows as records (seconds at millions of rows)
    order = np.lexsort(keys.T[::-1])
    srt = keys[order]
    new = np.ones(keys.shape[0], dtype=bool)
    new[1:] = (srt[1:] != srt[:-1]).any(axis=1)
    inverse = np.empty(keys.shape[0], dtype=np.int32)
    inverse[order] = np.cumsum(new) - 1
    return int(new.sum()), inverse, order[new].astype(np.int64)


def cartesian(dim: int, n: tuple, sizes: tuple) -> Mesh:
    """Cartesian mesh of [0,Sx](x[0,Sy](x[0,Sz])) with MFEM-style bdr
    attrs.

    Mirrors MakeCartesian{1,2,3}D + AssignMeshBdrAttrs (laghos.cpp:428-445).
    """
    n = tuple(int(v) for v in n[:dim])
    sizes = tuple(float(s) for s in sizes[:dim])
    axes = [np.linspace(0.0, sizes[d], n[d] + 1) for d in range(dim)]
    grids = np.meshgrid(*axes, indexing="ij")
    # vertex id layout: x fastest
    shape = tuple(v + 1 for v in n)
    verts = np.stack([g.reshape(-1, order="F") for g in grids], axis=1)

    def vid(idx):
        # idx = (ix, iy, iz); x fastest
        out = idx[0]
        mult = shape[0]
        for d in range(1, dim):
            out = out + idx[d] * mult
            mult *= shape[d]
        return out

    elems = []
    for cell in np.ndindex(*reversed(n)):
        cell = tuple(reversed(cell))  # (ix, iy, iz)
        corners = []
        for corner in np.ndindex(*(2,) * dim):
            corner = tuple(reversed(corner))
            corners.append(vid([cell[d] + corner[d] for d in range(dim)]))
        # corners is in lattice order (x fastest); reorder to MFEM ordering
        elems.append([corners[_MFEM_TO_CORNER[dim][j]]
                      for j in range(2**dim)])
    elems = np.array(elems, dtype=np.int32)

    bdr_verts, bdr_attr = [], []
    if dim == 1:
        bdr_verts = [[vid([0])], [vid([n[0]])]]
        bdr_attr = [1, 1]
    else:
        # faces on the domain boundary; attr by face-center position
        for d in range(dim):
            for side in (0, 1):
                for cell in np.ndindex(*[n[k] for k in range(dim)
                                         if k != d]):
                    idx = list(cell)
                    idx.insert(d, side * n[d])
                    face = _face_corners(idx, d, dim)
                    bdr_verts.append([vid(f) for f in face])
                    bdr_attr.append(0)  # assigned after
    bv = np.array(bdr_verts, dtype=np.int32)
    ba = np.array(bdr_attr, dtype=np.int32)
    m = Mesh(dim, verts, elems, bv, ba)
    if dim == 2:
        assign_bdr_attrs_2d(m, 0.0, sizes[0])
    elif dim == 3:
        assign_bdr_attrs_3d(m, 0.0, sizes[0], 0.0, sizes[1])
    return m


def _face_corners(idx, d, dim):
    """Corner lattice indices of the boundary face at fixed dim d, in cyclic
    (CCW-in-face) order so faces can later be refined edge-by-edge."""
    free = [k for k in range(dim) if k != d]
    if dim == 2:
        offsets = [(0,), (1,)]
    else:
        offsets = [(0, 0), (1, 0), (1, 1), (0, 1)]  # cyclic
    out = []
    for corner in offsets:
        full = list(idx)
        for j, k in enumerate(free):
            full[k] = idx[k] + corner[j]
        out.append(full)
    return out


def _bdr_face_centers(mesh: Mesh) -> np.ndarray:
    return mesh.verts[mesh.bdr_verts].mean(axis=1)


def assign_bdr_attrs_2d(mesh: Mesh, xmin: float, xmax: float, tol=1e-6):
    """attr 1 on x-extremes, else 2 (reference laghos.cpp:1476-1497)."""
    c = _bdr_face_centers(mesh)
    attr = np.where((c[:, 0] <= xmin + tol) | (c[:, 0] >= xmax - tol), 1, 2)
    mesh.bdr_attr = attr.astype(np.int32)


def assign_bdr_attrs_3d(mesh: Mesh, xmin, xmax, ymin, ymax, tol=1e-6):
    """attr 1 on x-extremes, 2 on y-extremes, else 3 (laghos.cpp:1499-1525)."""
    c = _bdr_face_centers(mesh)
    attr = np.full(c.shape[0], 3)
    ymask = (c[:, 1] <= ymin + tol) | (c[:, 1] >= ymax - tol)
    attr[ymask] = 2
    xmask = (c[:, 0] <= xmin + tol) | (c[:, 0] >= xmax - tol)
    attr[xmask] = 1
    mesh.bdr_attr = attr.astype(np.int32)


_ELEM_VERTS = {SEGMENT: 2, TRIANGLE: 3, SQUARE: 4, TETRAHEDRON: 4, CUBE: 8}
_BDR_VERTS = {0: 1, SEGMENT: 2, TRIANGLE: 3, SQUARE: 4}


def load_mfem_mesh(path: str) -> Mesh:
    """Read an MFEM mesh v1.0 ASCII file (straight-sided, single geometry).

    Handles both vertex storage variants of the reference data files:
    inline coordinates, or a trailing linear `nodes` grid function
    (Ordering 0: all x, then all y, ...).  A triangle or tetrahedron mesh
    raises SimplexMeshError: fem/simplex_mesh.py reads those.
    """
    with open(path) as f:
        tokens = []
        for line in f:
            line = line.split("#")[0].strip()
            if line:
                tokens.extend(line.split())
    it = iter(tokens)
    dim = None
    elems, bdr = [], []
    nv = 0
    verts = nodes_vals = vdim = None
    for tok in it:
        if tok == "dimension":
            dim = int(next(it))
        elif tok == "elements":
            for _ in range(int(next(it))):
                attr, geom = int(next(it)), int(next(it))
                elems.append((attr, geom, [int(next(it))
                                           for _ in range(_ELEM_VERTS[geom])]))
        elif tok == "boundary":
            for _ in range(int(next(it))):
                attr, geom = int(next(it)), int(next(it))
                bdr.append((attr, [int(next(it))
                                   for _ in range(_BDR_VERTS[geom])]))
        elif tok == "vertices":
            nv = int(next(it))
            tok2 = next(it, None)
            if tok2 is None:
                break
            if tok2 == "nodes":
                # FiniteElementSpace, FiniteElementCollection: <name>,
                # VDim: v, Ordering: o, then the values
                rest = list(it)
                vals = []
                i = 0
                while i < len(rest):
                    t = rest[i]
                    if t == "FiniteElementSpace":
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
            vdim = int(tok2)
            verts = np.array([float(next(it))
                              for _ in range(nv * vdim)]).reshape(nv, vdim)
    if verts is None:
        verts = nodes_vals.reshape(vdim, nv).T

    geoms = {g for (_, g, _) in elems}
    if len(geoms) != 1:
        raise NotImplementedError(f"mixed-geometry mesh: {geoms}")
    if geoms & {TRIANGLE, TETRAHEDRON}:
        raise SimplexMeshError(
            f"{path}: a simplex mesh; read it with "
            "fem.simplex_mesh.load_simplex_mesh (data.get_mesh does)")
    e = np.array([v for (_, _, v) in elems], dtype=np.int32)
    bv = np.array([v for (_, v) in bdr], dtype=np.int32).reshape(
        len(bdr), -1)
    ba = np.array([a for (a, _) in bdr], dtype=np.int32)
    return Mesh(dim, verts[:, :dim].astype(np.float64), e, bv, ba)


def load_netgen_2d(path: str) -> Mesh:
    """Read a NetGen 2D 'areamesh2' ASCII mesh of quads (MFEM's NetGen
    reader, used for the reference's data/square01_quad_unstr.mesh).

    Header line ``areamesh2``; boundary-segment count then rows
    ``attr v0 v1``; element count then rows ``attr nv v1 .. v_nv``; vertex
    count then rows ``x y``.  Vertex ids are 1-based; quad rows are CCW,
    MFEM's quad vertex ordering, so rows are stored verbatim.
    """
    with open(path) as f:
        tokens = f.read().split()
    if tokens[0] != "areamesh2":
        raise ValueError(f"not a NetGen areamesh2 file: {path}")
    it = iter(tokens[1:])
    nb = int(next(it))
    bdr = []
    for _ in range(nb):
        attr = int(next(it))
        bdr.append((attr, [int(next(it)) - 1, int(next(it)) - 1]))
    elems = []
    for _ in range(int(next(it))):
        next(it)                                      # element attribute
        if int(next(it)) != 4:
            raise NotImplementedError(
                "only quad areamesh2 meshes are supported")
        elems.append([int(next(it)) - 1 for _ in range(4)])
    nv = int(next(it))
    verts = np.array([[float(next(it)), float(next(it))]
                      for _ in range(nv)])
    e = np.array(elems, dtype=np.int32)
    bv = np.array([v for (_, v) in bdr], dtype=np.int32).reshape(nb, 2)
    ba = np.array([a for (a, _) in bdr], dtype=np.int32)
    return Mesh(2, verts, e, bv, ba)


def write_mfem_mesh(mesh: Mesh, path: str):
    """Write an MFEM mesh v1.0 ASCII file (inline vertex coordinates),
    readable by MFEM's tools and by `load_mfem_mesh`."""
    geom = {1: SEGMENT, 2: SQUARE, 3: CUBE}[mesh.dim]
    bgeom = {1: 0, 2: SEGMENT, 3: SQUARE}[mesh.dim]
    with open(path, "w") as f:
        f.write("MFEM mesh v1.0\n\ndimension\n%d\n\n" % mesh.dim)
        f.write("elements\n%d\n" % mesh.num_elems)
        for row in mesh.elems:
            f.write("1 %d %s\n" % (geom, " ".join(str(v) for v in row)))
        f.write("\nboundary\n%d\n" % mesh.bdr_verts.shape[0])
        for attr, row in zip(mesh.bdr_attr, mesh.bdr_verts):
            f.write("%d %d %s\n" % (attr, bgeom,
                                    " ".join(str(v) for v in row)))
        f.write("\nvertices\n%d\n%d\n" % (mesh.num_verts, mesh.dim))
        for v in mesh.verts:
            f.write(" ".join(repr(float(c)) for c in v) + "\n")


def uniform_refine(mesh: Mesh) -> Mesh:
    """One level of uniform (1:2^dim) refinement, conforming.

    Every candidate node (vertex/edge-mid/face-center/cell-center) is
    identified across elements by its sorted supporting-vertex key and
    deduplicated by `unify_rows`.
    """
    d = mesh.dim
    NE = mesh.num_elems
    ncor = 2**d
    lat_corners = mesh.corners_lattice().astype(np.int64)   # (NE, ncor)

    # {0,1,2}^d lattice points per element, x fastest
    rng = np.arange(3)
    grids = np.meshgrid(*([rng] * d), indexing="ij")
    pts = np.stack([g.reshape(-1, order="F") for g in grids], axis=1)
    npts = 3**d
    support = np.ones((npts, ncor), dtype=bool)
    for dd in range(d):
        ix = pts[:, dd][:, None]
        bit = (np.arange(ncor) >> dd) & 1
        support &= (((ix == 0) & (bit == 0)) | ((ix == 2) & (bit == 1))
                    | (ix == 1))

    elem_keys = np.where(support[None], lat_corners[:, None, :], -1)
    elem_keys = np.sort(elem_keys, axis=-1)                 # (NE, npts, ncor)

    # candidate-node coordinates: mean over supporting vertices
    cs = mesh.verts[lat_corners]                            # (NE, ncor, dim)
    cnt = support.sum(axis=1).astype(np.float64)            # (npts,)
    coords = (np.einsum("pc,ecd->epd", support.astype(np.float64), cs)
              / cnt[None, :, None])                         # (NE, npts, dim)

    # boundary child rows (reusing the same key space)
    bdr_rows = None
    bdr_coords = None
    NB = mesh.bdr_verts.shape[0]
    if NB:
        fv = mesh.bdr_verts.astype(np.int64)            # (NB, 2^(d-1))
        if d == 1:
            bdr_rows = np.sort(np.concatenate(
                [fv, np.full((NB, ncor - 1), -1, np.int64)], axis=1),
                axis=1)[:, None, :]                     # (NB, 1, ncor)
            bdr_coords = mesh.verts[fv[:, 0]][:, None, :]
        elif d == 2:
            z = np.full((NB, 1), -1, dtype=np.int64)
            r0 = np.sort(np.concatenate([fv[:, :1], z], axis=1), axis=1)
            r1 = np.sort(fv, axis=1)
            r2 = np.sort(np.concatenate([fv[:, 1:2], z], axis=1), axis=1)
            bdr_rows = np.stack([r0, r1, r2], axis=1)   # (NB, 3, 2)
            pad = np.full((NB, 3, ncor - 2), -1, dtype=np.int64)
            bdr_rows = np.concatenate([pad, bdr_rows], axis=-1)
            bdr_coords = np.stack(
                [mesh.verts[fv[:, 0]], mesh.verts[fv].mean(axis=1),
                 mesh.verts[fv[:, 1]]], axis=1)
        else:
            # face lattice (0,0)=v0 (1,0)=v1 (1,1)=v2 (0,1)=v3 (fv cyclic)
            fl = np.stack([fv[:, 0], fv[:, 1], fv[:, 3], fv[:, 2]], axis=1)
            g2 = np.meshgrid(rng, rng, indexing="ij")
            p2 = np.stack([g.reshape(-1, order="F") for g in g2], axis=1)
            sup2 = np.ones((9, 4), dtype=bool)
            for dd in range(2):
                ix = p2[:, dd][:, None]
                bit = (np.arange(4) >> dd) & 1
                sup2 &= (((ix == 0) & (bit == 0))
                         | ((ix == 2) & (bit == 1)) | (ix == 1))
            rows = np.where(sup2[None], fl[:, None, :], -1)
            rows = np.sort(rows, axis=-1)               # (NB, 9, 4)
            pad = np.full((NB, 9, ncor - 4), -1, dtype=np.int64)
            bdr_rows = np.concatenate([pad, rows], axis=-1)
            fvv = mesh.verts[fl]                        # (NB, 4, dim)
            bdr_coords = (np.einsum("pc,ncd->npd",
                                    sup2.astype(np.float64), fvv)
                          / sup2.sum(axis=1)[None, :, None])

    all_rows = elem_keys.reshape(-1, ncor)
    all_coords = coords.reshape(-1, d)
    if bdr_rows is not None:
        all_rows = np.concatenate([all_rows, bdr_rows.reshape(-1, ncor)])
        all_coords = np.concatenate([all_coords,
                                     bdr_coords.reshape(-1, d)])

    nnew, inverse, first = unify_rows(all_rows)
    new_verts = all_coords[first]

    inv_elem = inverse[:NE * npts].reshape(NE, npts)
    # children
    new_elems = np.empty((NE, ncor, ncor), dtype=np.int64)  # (NE, child, c)
    for ci, child in enumerate(_bits(d)):
        for cc_i, cc in enumerate(_bits(d)):
            flat = sum((child[k] + cc[k]) * 3**k for k in range(d))
            new_elems[:, ci, cc_i] = inv_elem[:, flat]
    # lattice -> mfem corner order
    perm = _MFEM_TO_CORNER[d]
    new_elems = new_elems[:, :, perm].reshape(NE * ncor, ncor)

    new_bdr = np.zeros((0, 2 ** (d - 1)), dtype=np.int64)
    new_attr = np.zeros(0, dtype=np.int64)
    if NB:
        inv_b = inverse[NE * npts:].reshape(NB, -1)
        if d == 1:
            new_bdr = inv_b.reshape(NB, 1)
            new_attr = mesh.bdr_attr.copy()
        elif d == 2:
            ch = np.stack([inv_b[:, [0, 1]], inv_b[:, [1, 2]]], axis=1)
            new_bdr = ch.reshape(NB * 2, 2)
            new_attr = np.repeat(mesh.bdr_attr, 2)
        else:
            chs = []
            for fy in (0, 1):
                for fx in (0, 1):
                    def fid(ax, ay):
                        return inv_b[:, (fx + ax) + 3 * (fy + ay)]
                    chs.append(np.stack(
                        [fid(0, 0), fid(1, 0), fid(1, 1), fid(0, 1)],
                        axis=1))
            new_bdr = np.stack(chs, axis=1).reshape(NB * 4, 4)
            new_attr = np.repeat(mesh.bdr_attr, 4)

    return Mesh(
        d,
        new_verts,
        new_elems.astype(np.int32),
        np.asarray(new_bdr, dtype=np.int32).reshape(-1, 2 ** (d - 1)),
        np.asarray(new_attr, dtype=np.int32),
    )


def _bits(d):
    out = []
    for i in range(2**d):
        out.append(tuple((i >> k) & 1 for k in range(d)))
    return out
