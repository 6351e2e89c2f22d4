"""Simplex (triangle/tetrahedron) discretization: quadrature, bases, tables.

The reference supports simplex meshes through MFEM (data/square01_tri.mesh;
TETRAHEDRON in the geometry switch) on the full-assembly path.  Here: P_k
nodal H1 (barycentric-lattice Lagrange), barycentric Bernstein L2
("Positive"), and Duffy-collapsed Gauss quadrature.  No tensor structure:
operators use full (NQ, nd) tables, the reference's FA regime for
simplices.  Host NumPy, the same tables as `laghos_tpu.fem.simplex`.

Reference points: (x, y[, z]) in the unit simplex with coords >= 0 and
sum <= 1 (MFEM's triangle / tetrahedron reference elements).
"""

from __future__ import annotations

import functools
from math import factorial

import numpy as np

from .quadrature import gauss_legendre


@functools.lru_cache(maxsize=None)
def tri_quadrature(order: int):
    """Duffy-collapsed Gauss rule exact to `order` on the unit triangle."""
    n = order // 2 + 1
    xg, wg = gauss_legendre(n)
    # Duffy: (u, v) in [0,1]^2 -> (x, y) = (u(1-v), v); |J| = (1-v)
    # use a Jacobi-weighted rule in v for efficiency: plain GL + weight
    nv = n + 1
    xv, wv = gauss_legendre(nv)
    X, Y, W = [], [], []
    for i in range(n):
        for j in range(nv):
            X.append(xg[i] * (1.0 - xv[j]))
            Y.append(xv[j])
            W.append(wg[i] * wv[j] * (1.0 - xv[j]))
    return np.array(X), np.array(Y), np.array(W)


def _bary_lattice(p: int):
    """Barycentric lattice multi-indices (i, j, k), i+j+k = p.

    Node order: lexicographic in (j, i) — vertices first is NOT required
    since global numbering is key-based.
    """
    out = []
    for j in range(p + 1):
        for i in range(p + 1 - j):
            out.append((i, j, p - i - j))
    return np.array(out)  # (nd, 3); x = i/p, y = j/p


def _dubiner(p: int, x, y):
    """Orthogonal (monomial fallback) basis on the triangle: returns
    (npts, nd) matrix of span {x^a y^b : a+b <= p}."""
    x = np.asarray(x)
    y = np.asarray(y)
    cols = []
    for total in range(p + 1):
        for a in range(total + 1):
            b = total - a
            cols.append(x**a * y**b)
    return np.stack(cols, axis=1)


def _dubiner_grad(p: int, x, y):
    x = np.asarray(x)
    y = np.asarray(y)
    gx, gy = [], []
    for total in range(p + 1):
        for a in range(total + 1):
            b = total - a
            gx.append(a * x ** max(a - 1, 0) * y**b if a else 0.0 * x)
            gy.append(b * x**a * y ** max(b - 1, 0) if b else 0.0 * x)
    return np.stack(gx, axis=1), np.stack(gy, axis=1)


@functools.lru_cache(maxsize=None)
def h1_tri_tables(p: int, order: int):
    """Nodal P_k basis tables at the quadrature points.

    Returns dict with B (NQ, nd), Gx/Gy (NQ, nd), nodes (nd, 2) reference
    positions, lattice (nd, 3) barycentric indices, quadrature (X, Y, W).
    """
    lat = _bary_lattice(p)
    nodes = np.stack([lat[:, 0] / p, lat[:, 1] / p], axis=1)
    V = _dubiner(p, nodes[:, 0], nodes[:, 1])       # (nd, nm)
    Vi = np.linalg.inv(V)                           # nodal coeffs
    X, Y, W = tri_quadrature(order)
    Pq = _dubiner(p, X, Y)
    Gqx, Gqy = _dubiner_grad(p, X, Y)
    B = Pq @ Vi
    Gx = Gqx @ Vi
    Gy = Gqy @ Vi
    return {"B": B, "Gx": Gx, "Gy": Gy, "nodes": nodes, "lattice": lat,
            "quad": (X, Y, W)}


def bernstein_tri(p: int, x, y):
    """Barycentric Bernstein basis B_{ijk} = p!/(i!j!k!) x^i y^j (1-x-y)^k
    at points (x, y); column order matches _bary_lattice."""
    x = np.asarray(x)
    y = np.asarray(y)
    z = 1.0 - x - y
    lat = _bary_lattice(p)
    cols = []
    for (i, j, k) in lat:
        c = factorial(p) // (factorial(i) * factorial(j) * factorial(k))
        cols.append(c * x**i * y**j * z**k)
    return np.stack(cols, axis=1)


@functools.lru_cache(maxsize=None)
def l2_tri_tables(p: int, order: int):
    """Bernstein L2 tables at quadrature points + the nodal->Bernstein
    change of basis (ICs are interpolated at the lattice points first)."""
    X, Y, W = tri_quadrature(order)
    B = bernstein_tri(p, X, Y)
    lat = _bary_lattice(p)
    nodes = np.stack([lat[:, 0] / p, lat[:, 1] / p], axis=1)
    Vb = bernstein_tri(p, nodes[:, 0], nodes[:, 1])
    return {"B": B, "nodal_to_b": np.linalg.inv(Vb), "nodes": nodes,
            "quad": (X, Y, W)}


# ---------------------------------------------------------------------------
# Tetrahedra (3D simplices).  Same construction, one more barycentric
# coordinate.  Closes the reference's TETRAHEDRON geometry-switch entry
# (MFEM Geometry::TETRAHEDRON; the hydro semantics are dimension-generic).
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def tet_quadrature(order: int):
    """Duffy-collapsed Gauss rule exact to `order` on the unit tetrahedron.

    Map from [0,1]^3: (x, y, z) = (u(1-v)(1-w), v(1-w), w);
    |J| = (1-v)(1-w)^2.  The weight raises the polynomial degree in v by 1
    and in w by 2, so those directions get 1 and 2 extra Gauss points.
    """
    n = order // 2 + 1
    xu, wu = gauss_legendre(n)
    xv, wv = gauss_legendre(n + 1)
    xw, ww = gauss_legendre(n + 2)
    U, V, Wc = np.meshgrid(xu, xv, xw, indexing="ij")
    WU, WV, WW = np.meshgrid(wu, wv, ww, indexing="ij")
    Z = Wc.reshape(-1)
    Y = (V * (1.0 - Wc)).reshape(-1)
    X = (U * (1.0 - V) * (1.0 - Wc)).reshape(-1)
    W = (WU * WV * WW * (1.0 - V) * (1.0 - Wc) ** 2).reshape(-1)
    return X, Y, Z, W


def _bary_lattice_tet(p: int):
    """Barycentric lattice multi-indices (i, j, k, l), i+j+k+l = p;
    node position x = i/p, y = j/p, z = k/p."""
    out = []
    for k in range(p + 1):
        for j in range(p + 1 - k):
            for i in range(p + 1 - k - j):
                out.append((i, j, k, p - i - j - k))
    return np.array(out)  # (nd, 4)


def _monomials3(p: int, x, y, z):
    """(npts, nd) matrix of span {x^a y^b z^c : a+b+c <= p}."""
    x, y, z = np.asarray(x), np.asarray(y), np.asarray(z)
    cols = []
    for total in range(p + 1):
        for a in range(total + 1):
            for b in range(total + 1 - a):
                c = total - a - b
                cols.append(x**a * y**b * z**c)
    return np.stack(cols, axis=1)


def _monomials3_grad(p: int, x, y, z):
    x, y, z = np.asarray(x), np.asarray(y), np.asarray(z)
    gx, gy, gz = [], [], []
    for total in range(p + 1):
        for a in range(total + 1):
            for b in range(total + 1 - a):
                c = total - a - b
                gx.append(a * x ** max(a - 1, 0) * y**b * z**c
                          if a else 0.0 * x)
                gy.append(b * x**a * y ** max(b - 1, 0) * z**c
                          if b else 0.0 * x)
                gz.append(c * x**a * y**b * z ** max(c - 1, 0)
                          if c else 0.0 * x)
    return (np.stack(gx, axis=1), np.stack(gy, axis=1),
            np.stack(gz, axis=1))


@functools.lru_cache(maxsize=None)
def h1_tet_tables(p: int, order: int):
    """Nodal P_k basis tables at the tet quadrature points.

    Returns dict with B (NQ, nd), Gx/Gy/Gz (NQ, nd), nodes (nd, 3)
    reference positions, lattice (nd, 4), quadrature (X, Y, Z, W).
    """
    lat = _bary_lattice_tet(p)
    nodes = lat[:, :3].astype(np.float64) / p
    V = _monomials3(p, nodes[:, 0], nodes[:, 1], nodes[:, 2])
    Vi = np.linalg.inv(V)
    X, Y, Z, W = tet_quadrature(order)
    Pq = _monomials3(p, X, Y, Z)
    Gqx, Gqy, Gqz = _monomials3_grad(p, X, Y, Z)
    return {"B": Pq @ Vi, "Gx": Gqx @ Vi, "Gy": Gqy @ Vi, "Gz": Gqz @ Vi,
            "nodes": nodes, "lattice": lat, "quad": (X, Y, Z, W)}


def bernstein_tet(p: int, x, y, z):
    """Barycentric Bernstein basis B_{ijkl} at points (x, y, z); column
    order matches _bary_lattice_tet."""
    x, y, z = np.asarray(x), np.asarray(y), np.asarray(z)
    w = 1.0 - x - y - z
    lat = _bary_lattice_tet(p)
    cols = []
    for (i, j, k, l) in lat:
        c = (factorial(p) //
             (factorial(i) * factorial(j) * factorial(k) * factorial(l)))
        cols.append(c * x**i * y**j * z**k * w**l)
    return np.stack(cols, axis=1)


@functools.lru_cache(maxsize=None)
def l2_tet_tables(p: int, order: int):
    """Bernstein L2 tables at tet quadrature points + nodal->Bernstein
    change of basis."""
    X, Y, Z, W = tet_quadrature(order)
    B = bernstein_tet(p, X, Y, Z)
    lat = _bary_lattice_tet(p)
    nodes = lat[:, :3].astype(np.float64) / p
    Vb = bernstein_tet(p, nodes[:, 0], nodes[:, 1], nodes[:, 2])
    return {"B": B, "nodal_to_b": np.linalg.inv(Vb), "nodes": nodes,
            "quad": (X, Y, Z, W)}
