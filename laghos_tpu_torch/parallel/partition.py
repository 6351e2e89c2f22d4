"""Geometric element partitioning for unstructured meshes (-sfc).

The reference partitions unstructured meshes with METIS (laghos.cpp:
ParMesh(MPI_COMM_WORLD, *mesh)); `laghos_tpu.parallel.partition` replaces
the graph library by ordering elements along a Morton (Z-order) curve of
their centroids, so that equal contiguous chunks of the element order are
the ranks' parts, with small interfaces.  The port's copy, in NumPy.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def morton_codes(pts: np.ndarray, bits: int = 21) -> np.ndarray:
    """Interleaved-bit Z-order codes of points (N, dim), dim in {1,2,3}."""
    n, d = pts.shape
    lo = pts.min(axis=0)
    span = pts.max(axis=0) - lo
    span[span == 0.0] = 1.0
    q = ((pts - lo) / span * ((1 << bits) - 1)).astype(np.uint64)
    codes = np.zeros(n, dtype=np.uint64)
    for b in range(bits):
        for dd in range(d):
            codes |= ((q[:, dd] >> np.uint64(b)) & np.uint64(1)) << \
                np.uint64(b * d + dd)
    return codes


def sfc_element_order(mesh) -> np.ndarray:
    """Permutation ordering mesh elements along the Morton curve of their
    vertex centroids."""
    cent = mesh.verts[mesh.elems].mean(axis=1)
    return np.argsort(morton_codes(cent), kind="stable")


def reorder_mesh_elements(mesh, order: np.ndarray):
    """Copy of `mesh` with elements permuted to `order` (element data only;
    vertices untouched)."""
    return dataclasses.replace(mesh, elems=mesh.elems[order])


def sfc_partition(mesh):
    """Mesh copy in SFC order: equal contiguous element chunks are the
    ranks' parts."""
    return reorder_mesh_elements(mesh, sfc_element_order(mesh))
