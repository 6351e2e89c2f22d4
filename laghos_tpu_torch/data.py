"""Built-in named meshes reproducing the reference data/ geometries.

The reference ships small MFEM-format meshes (data/*.mesh); the regular
tensor-product ones are built here in code, so the package needs no data
files.  Boundary attributes follow the fixed-x/y/z = 1/2/3 convention the
files encode.  `cube01_tet` is the Kuhn triangulation of the unit cube (a
`TetMesh`); `square01_tri` exists only as the reference's file.  `get_mesh`
also reads an existing MFEM v1.0 (quad, hex, triangle or tet) or NetGen
areamesh2 file given by path.
"""

from __future__ import annotations

import os

import numpy as np

from .fem import mesh as fmesh
from .fem.simplex_mesh import load_simplex_mesh, load_tri_mesh, make_tet_mesh


def _shifted(m: fmesh.Mesh, offset) -> fmesh.Mesh:
    m.verts = m.verts + np.asarray(offset)[None, :]
    return m


def _builtin(name: str):
    if name == "segment01":
        return fmesh.cartesian(1, (2,), (1.0,))
    if name == "square01_quad":
        return fmesh.cartesian(2, (2, 2), (1.0, 1.0))
    if name == "cube01_hex":
        return fmesh.cartesian(3, (2, 2, 2), (1.0, 1.0, 1.0))
    if name == "rectangle01_quad":
        return fmesh.cartesian(2, (7, 3), (7.0, 3.0))
    if name == "box01_hex":
        return fmesh.cartesian(3, (4, 2, 2), (7.0, 3.0, 3.0))
    if name == "square_gresho":
        m = fmesh.cartesian(2, (2, 2), (1.0, 1.0))
        m = _shifted(m, (-0.5, -0.5))
        fmesh.assign_bdr_attrs_2d(m, -0.5, 0.5)
        return m
    if name == "square_10x9_quad":
        return fmesh.cartesian(2, (10, 9), (1.0, 0.9))
    if name == "cube01_tet":
        return make_tet_mesh((2, 2, 2), (1.0, 1.0, 1.0))
    if name == "square01_tri":
        # only from the reference's own file, in the directory named by
        # LAGHOS_REFERENCE_DATA (no built-in stand-in, as in the JAX
        # package)
        p = os.path.join(os.environ.get("LAGHOS_REFERENCE_DATA", ""),
                         "square01_tri.mesh")
        if os.environ.get("LAGHOS_REFERENCE_DATA") and os.path.exists(p):
            return load_tri_mesh(p)
    if name == "rt2D":
        m = fmesh.cartesian(2, (1, 4), (0.5, 2.0))
        m = _shifted(m, (0.0, -1.0))
        fmesh.assign_bdr_attrs_2d(m, 0.0, 0.5)
        return m
    return None


def get_mesh(name_or_path: str) -> fmesh.Mesh:
    """The mesh file at `name_or_path` if it exists (MFEM v1.0 or NetGen
    areamesh2), else the built-in geometry of that name (a trailing
    `.mesh` and any directory part are ignored)."""
    if os.path.exists(name_or_path):
        with open(name_or_path) as f:
            head = f.readline().strip()
        if head == "areamesh2":
            return fmesh.load_netgen_2d(name_or_path)
        try:
            return fmesh.load_mfem_mesh(name_or_path)
        except fmesh.SimplexMeshError:
            return load_simplex_mesh(name_or_path)
    base = os.path.basename(name_or_path)
    if base.endswith(".mesh"):
        base = base[:-5]
    m = _builtin(base)
    if m is None:
        raise FileNotFoundError(
            f"no such mesh file or built-in geometry: {name_or_path}")
    return m
