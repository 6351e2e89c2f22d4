"""1D quadrature rules on the reference interval [0, 1].

Equivalent capability to MFEM's IntRules (as consumed by the reference at
laghos_solver.cpp:145-147): tensor-product Gauss-Legendre rules where a rule
of requested polynomial order `order` uses ``order // 2 + 1`` points per
dimension, plus Gauss-Lobatto point sets used for the H1 nodal basis.

Everything here is host-side NumPy in float64; tables are built once at
setup and copied to the device as tensors.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def gauss_legendre(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Legendre points/weights on [0, 1]."""
    x, w = np.polynomial.legendre.leggauss(n)
    x = np.asarray((x + 1.0) / 2.0)
    w = np.asarray(w / 2.0)
    # Newton-polish the roots in float64 for full precision.
    for _ in range(2):
        t = 2.0 * x - 1.0
        pn = np.polynomial.legendre.Legendre.basis(n)
        dpn = pn.deriv()
        x = x - pn(t) / (2.0 * dpn(t))
    t = 2.0 * x - 1.0
    dpn = np.polynomial.legendre.Legendre.basis(n).deriv()
    w = 1.0 / ((1.0 - t * t) * dpn(t) ** 2)
    return x, w


@functools.lru_cache(maxsize=None)
def gauss_lobatto(n: int) -> np.ndarray:
    """n-point Gauss-Lobatto points on [0, 1] (includes the endpoints).

    These are the H1 nodal points (MFEM BasisType::GaussLobatto, the default
    basis of H1_FECollection used at laghos.cpp:495).
    """
    if n < 2:
        raise ValueError("Gauss-Lobatto needs n >= 2")
    if n == 2:
        return np.array([0.0, 1.0])
    # Interior points: roots of P'_{n-1} on (-1, 1).
    pn1 = np.polynomial.legendre.Legendre.basis(n - 1)
    dp = pn1.deriv()
    t = np.polynomial.legendre.legroots(dp.coef)
    d2p = dp.deriv()
    for _ in range(3):
        t = t - dp(t) / d2p(t)
    x = np.concatenate([[-1.0], np.sort(t), [1.0]])
    return (x + 1.0) / 2.0


def points_for_order(order: int) -> int:
    """Number of 1D Gauss-Legendre points MFEM uses for a rule of `order`.

    Mirrors mfem::IntegrationRules for segment/square/cube geometries:
    a Gauss-Legendre rule with k points is exact to order 2k-1, and the rule
    of order p uses k = p // 2 + 1 points.
    """
    return order // 2 + 1


def default_rule_order(order_v: int, order_e: int, order_q: int = -1) -> int:
    """Integration-rule order: 3*ok + ot - 1 unless -oq overrides.

    (reference laghos_solver.cpp:145-146)
    """
    return order_q if order_q > 0 else 3 * order_v + order_e - 1
