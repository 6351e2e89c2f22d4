"""1D polynomial bases and dof-to-quadrature tables.

The reference uses three bases (laghos.cpp:491-497, 589-595):
  * H1 kinematic space: nodal Lagrange on Gauss-Lobatto points,
  * L2 thermodynamic space: Bernstein ("Positive" basis),
  * auxiliary nodal L2 on Gauss-Legendre points (only for initial-condition
    projection, laghos.cpp:591-595).

A `Basis1D` holds the value/derivative tables at a set of evaluation points
(the analog of MFEM's DofToQuad B/G arrays consumed by the force kernels,
laghos_assembly.cpp:141-142).
"""

from __future__ import annotations

import dataclasses
import functools
from math import comb

import numpy as np

from .quadrature import gauss_legendre, gauss_lobatto


def lagrange_tables(nodes: np.ndarray, pts: np.ndarray):
    """Values/derivatives of the Lagrange basis on `nodes` at `pts`.

    Returns (B, G) with B[q, i] = phi_i(pts[q]), G[q, i] = phi_i'(pts[q]).
    Uses the barycentric form for numerical stability.
    """
    nodes = np.asarray(nodes, dtype=np.float64)
    pts = np.asarray(pts, dtype=np.float64)
    n = nodes.size
    diff = nodes[:, None] - nodes[None, :]
    np.fill_diagonal(diff, 1.0)
    wbar = 1.0 / np.prod(diff, axis=1)

    B = np.zeros((pts.size, n))
    G = np.zeros((pts.size, n))
    for q, x in enumerate(pts):
        d = x - nodes
        exact = np.where(np.abs(d) < 1e-14)[0]
        if exact.size:
            i = int(exact[0])
            B[q, i] = 1.0
            # phi_j'(x_i) = (w_j/w_i)/(x_i - x_j) for j != i;
            # sum_j phi_j' = 0 fixes the diagonal entry.
            for j in range(n):
                if j != i:
                    G[q, j] = (wbar[j] / wbar[i]) / (nodes[i] - nodes[j])
            G[q, i] = -np.sum(G[q, :])
        else:
            # Normalized barycentric form: phi_j = t_j/s with t_j = w_j/d_j.
            t = wbar / d
            s = np.sum(t)
            B[q, :] = t / s
            tp = -wbar / d**2
            sp = np.sum(tp)
            G[q, :] = (tp * s - t * sp) / s**2
    return B, G


def bernstein_tables(p: int, pts: np.ndarray):
    """Bernstein basis of degree p at `pts`: B_i(x) = C(p,i) x^i (1-x)^(p-i).

    This is MFEM's BasisType::Positive used for the L2 energy space
    (laghos.cpp:494).
    """
    pts = np.asarray(pts, dtype=np.float64)
    n = p + 1
    B = np.zeros((pts.size, n))
    G = np.zeros((pts.size, n))
    for i in range(n):
        c = comb(p, i)
        B[:, i] = c * pts**i * (1.0 - pts) ** (p - i)
        d = np.zeros_like(pts)
        if i > 0:
            d += i * pts ** (i - 1) * (1.0 - pts) ** (p - i)
        if p - i > 0:
            d -= (p - i) * pts**i * (1.0 - pts) ** (p - i - 1)
        G[:, i] = c * d
    return B, G


@dataclasses.dataclass(frozen=True)
class Basis1D:
    """Value/derivative tables of a 1D basis at a point set."""

    p: int              # polynomial degree
    nodes: np.ndarray   # dof points (empty for modal bases)
    B: np.ndarray       # (npts, p+1) values
    G: np.ndarray       # (npts, p+1) derivatives


@functools.lru_cache(maxsize=None)
def h1_gl_basis(p: int, nq: int) -> Basis1D:
    """Lagrange/Gauss-Lobatto basis of degree p at nq Gauss-Legendre points."""
    nodes = gauss_lobatto(p + 1)
    pts, _ = gauss_legendre(nq)
    B, G = lagrange_tables(nodes, pts)
    return Basis1D(p, nodes, B, G)


@functools.lru_cache(maxsize=None)
def l2_bernstein_basis(p: int, nq: int) -> Basis1D:
    """Bernstein basis of degree p at nq Gauss-Legendre points."""
    pts, _ = gauss_legendre(nq)
    B, G = bernstein_tables(p, pts)
    return Basis1D(p, np.empty(0), B, G)


@functools.lru_cache(maxsize=None)
def nodal_to_bernstein(p: int) -> np.ndarray:
    """Change of basis: Gauss-Legendre nodal L2 coefficients -> Bernstein.

    MFEM's ProjectGridFunction between same-degree L2 spaces reduces to the
    inverse of the Bernstein Vandermonde at the nodal points (exact change of
    basis of the same polynomial), which is how the reference converts initial
    conditions into the positive basis (laghos.cpp:589-624).
    """
    nodes, _ = gauss_legendre(p + 1)
    V, _ = bernstein_tables(p, nodes)  # V[i, j] = B_j(node_i)
    return np.linalg.inv(V)
