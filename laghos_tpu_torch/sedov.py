"""Analytic Taylor-von Neumann-Sedov blast-wave solution + error norm.

The counterpart of `laghos_tpu.sedov`, the same NumPy arithmetic.
Capability equivalent of the reference's `sedov/` module
(sedov/sedov_sol.cpp, Kamm & Timmes LA-UR-00-6055): the similarity
exponents/energy integral alpha via adaptive Gauss quadrature, the
standard/singular/vacuum branches, and V(r) by bisection — vectorized over
radii.  Used for the `-err` density-L2-error check (laghos.cpp:1007-1086).
"""

from __future__ import annotations

import numpy as np


def _adaptive_gauss(f, a, b, eps=1.49e-15, max_depth=60):
    """Adaptive Gauss-Legendre integration with 10/21-point error control.

    Same role as the reference's GK21 adaptive scheme
    (sedov/adaptive_quad.hpp); tolerances chosen so alpha agrees to 1e-13.
    """
    x10, w10 = np.polynomial.legendre.leggauss(10)
    x21, w21 = np.polynomial.legendre.leggauss(21)

    def quad(xs, ws, lo, hi):
        mid, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
        return half * np.sum(ws * np.array([f(mid + half * t) for t in xs]))

    total = 0.0
    stack = [(a, b, max_depth)]
    while stack:
        lo, hi, depth = stack.pop()
        c = quad(x21, w21, lo, hi)
        cl = quad(x10, w10, lo, hi)
        if abs(c - cl) <= eps * max(1.0, abs(c)) or depth == 0:
            total += c
            continue
        mid = 0.5 * (lo + hi)
        stack.append((lo, mid, depth - 1))
        stack.append((mid, hi, depth - 1))
    return total


class SedovSolution:
    """Self-similar point-blast solution (plane/cylindrical/spherical)."""

    def __init__(self, dim, gamma, rho_0, blast_energy, omega=0.0):
        self.dim = dim
        self.gamma = gamma
        self.rho_0 = rho_0
        self.omega = omega
        self.blast_energy = blast_energy
        g, d, w = gamma, dim, omega

        self.a = (d + 2 - w) * (g + 1) * 0.25
        self.b = (g + 1) / (g - 1)
        self.c = (d + 2 - w) * g * 0.5
        self.d_ = ((d + 2 - w) * (g + 1)
                   / ((d + 2 - w) * (g + 1) - 2 * (2 + d * (g - 1))))
        self.e = (2 + d * (g - 1)) * 0.5

        self.alpha0 = 2.0 / (d + 2 - w)
        self.alpha2 = -(g - 1) / (2 * (g - 1) + d - g * w)
        self.alpha1 = ((d + 2 - w) * g / (2 + d * (g - 1))
                       * (2 * (d * (2 - g) - w) / (g * (d + 2 - w) ** 2)
                          - self.alpha2))
        self.alpha3 = (d - w) / (2 * (g - 1) + d - d * w)
        self.alpha4 = ((d + 2 - w) * (d - w) * self.alpha1
                       / (d * (2 - g) - w))
        self.alpha5 = (w * (1 + g) - 2 * d) / (d * (2 - g) - w)

        self.V0 = 2.0 / ((d + 2 - w) * g)
        self.Vv = 2.0 / (d + 2 - w)
        self.V2 = 4.0 / ((d + 2 - w) * (g + 1))
        self.Vs = 2.0 / ((g - 1) * d + 2)

        if self.V2 == self.Vs:
            alpha = ((g + 1) / (g - 1) * 2**d
                     / (d * ((g - 1) * d + 2)) ** 2)
            if d > 1:
                alpha *= np.pi
        else:
            Vmin = min(self.V0, self.Vv)
            J1 = _adaptive_gauss(self._j1_integrand, Vmin, self.V2)
            J2 = _adaptive_gauss(self._j2_integrand, Vmin, self.V2)
            I1 = 2.0 ** (d - 2) * J1
            I2 = 2.0 ** (d - 1) / (g - 1) * J2
            if d > 1:
                I1 *= np.pi
                I2 *= np.pi
            alpha = I1 + I2
        self.alpha = alpha
        self.t = 0.0

    # -- similarity-variable helper functions (Kamm's x1..x4) -------------
    def _x1(self, V):
        return self.a * V

    def _x2(self, V):
        return self.b * (self.c * V - 1)

    def _x3(self, V):
        return self.d_ * (1 - self.e * V)

    def _x4(self, V):
        return self.b * (1 - self.c * V / self.gamma)

    def _j1_integrand(self, V):
        g, d, w = self.gamma, self.dim, self.omega
        a0, a1, a2, a3, a4, a5 = (self.alpha0, self.alpha1, self.alpha2,
                                  self.alpha3, self.alpha4, self.alpha5)
        # x2(V) -> 0 at the integration endpoint; the resulting inf/0
        # terms are discarded by the adaptive quadrature's endpoint
        # handling — silence the benign warnings at the source
        with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
            return (-(g + 1) / (g - 1) * V**2
                    * (a0 / V + a2 * self.c / (self.c * V - 1)
                       - a1 * self.e / (1 - self.e * V))
                    * (self._x1(V) ** a0 * self._x2(V) ** a2
                       * self._x3(V) ** a1) ** (-(d + 2 - w))
                    * self._x2(V) ** a3 * self._x3(V) ** a4
                    * self._x4(V) ** a5)

    def _j2_integrand(self, V):
        g, d, w = self.gamma, self.dim, self.omega
        a0, a1, a2, a3, a4, a5 = (self.alpha0, self.alpha1, self.alpha2,
                                  self.alpha3, self.alpha4, self.alpha5)
        denom = 1 - self.c * V
        if abs(denom) <= 1e-15:
            denom = np.copysign(1e-15, denom)
        with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
            return (-(g + 1) / (2 * g) * V**2 * (self.c * V - g) / denom
                    * (a0 / V + a2 * self.c / -denom
                       - a1 * self.e / (1 - self.e * V))
                    * (self._x1(V) ** a0 * self._x2(V) ** a2
                       * self._x3(V) ** a1) ** (-(d + 2 - w))
                    * self._x2(V) ** a3 * self._x3(V) ** a4
                    * self._x4(V) ** a5)

    def set_time(self, t):
        d, w = self.dim, self.omega
        self.t = t
        self.r2 = ((self.blast_energy / (self.alpha * self.rho_0))
                   ** (1.0 / (d + 2 - w)) * t ** (2.0 / (d + 2 - w)))
        self.U = (2.0 / (d + 2 - w)) * (self.r2 / t)
        self.rho1 = self.rho_0 * self.r2 ** (-w)
        self.rho2 = (self.gamma + 1) / (self.gamma - 1) * self.rho1
        self.v2 = 2.0 / (self.gamma + 1) * self.U
        self.p2 = 2.0 / (self.gamma + 1) * self.rho1 * self.U**2

    def _lmbda(self, V):
        return (self._x1(V) ** -self.alpha0 * self._x2(V) ** -self.alpha2
                * self._x3(V) ** -self.alpha1)

    def eval(self, r):
        """Vectorized (rho, v, P) at radii r (post set_time)."""
        r = np.atleast_1d(np.asarray(r, dtype=np.float64))
        rho = self.rho_0 * np.where(r > 0, r, 1.0) ** (-self.omega) * (
            r >= self.r2)
        if self.omega == 0.0:
            rho = np.where(r >= self.r2, self.rho_0, 0.0)
        v = np.zeros_like(r)
        P = np.zeros_like(r)
        inside = r < self.r2
        if not np.any(inside):
            return rho, v, P
        ri = r[inside]
        g, d, w = self.gamma, self.dim, self.omega
        if self.V2 == self.Vs:  # singular
            rho_i = self.rho2 * (ri / self.r2) ** (d - 2)
            v_i = self.v2 * ri / self.r2
            P_i = self.p2 * (ri / self.r2) ** d
        else:
            lo = self.V0 if self.V2 < self.Vs else self.Vv
            V = self._bisect_V(ri, lo, self.V2)
            a0, a1, a2, a3, a4, a5 = (self.alpha0, self.alpha1, self.alpha2,
                                      self.alpha3, self.alpha4, self.alpha5)
            f = self._x1(V) * self._lmbda(V)
            gg = (self._x1(V) ** (a0 * w) * self._x2(V) ** (a3 + a2 * w)
                  * self._x3(V) ** (a4 + a1 * w) * self._x4(V) ** a5)
            h = (self._x1(V) ** (a0 * d)
                 * self._x3(V) ** (a4 + a1 * (w - 2))
                 * self._x4(V) ** (1 + a5))
            rho_i = self.rho2 * gg
            v_i = self.v2 * f
            P_i = self.p2 * h
            if self.V2 > self.Vs:  # vacuum branch
                r_vac = self.r2 * self._lmbda(self.Vv)
                vac = ri <= r_vac
                rho_i = np.where(vac, 0.0, rho_i)
                v_i = np.where(vac, 0.0, v_i)
                P_i = np.where(vac, 0.0, P_i)
        rho[inside] = rho_i
        v[inside] = v_i
        P[inside] = P_i
        return rho, v, P

    def _bisect_V(self, r, lo, hi, iters=200):
        """Vectorized bisection solving r2 * lambda(V) = r."""
        lo = np.full_like(r, lo)
        hi = np.full_like(r, hi)
        flo = self.r2 * self._lmbda(lo) - r
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            fm = self.r2 * self._lmbda(mid) - r
            same = np.sign(fm) == np.sign(flo)
            lo = np.where(same, mid, lo)
            flo = np.where(same, fm, flo)
            hi = np.where(same, hi, mid)
        return 0.5 * (lo + hi)


def sedov_density_l2_error(hydro, S, t_final, blast_energy,
                           blast_position=(0.0, 0.0, 0.0)):
    """Density L2 error against the exact solution (laghos.cpp:1007-1086).

    Evaluates the simulated density (pointwise mass conservation, projected
    to L2 by `compute_density`) and the exact density at a high-order rule
    on the current mesh and integrates the squared difference.  Host NumPy
    and CPU torch, on a copy of the state.
    """
    import torch

    from .fem import basis as fb
    from .fem import quadrature as fq
    from .ops import qupdate as qop

    d = hydro.dim
    opt = hydro.opt
    err_order = max((max(opt.order_v, opt.order_e) + 1) * 2,
                    opt.order_q) * 2
    nq1 = fq.points_for_order(err_order)
    _, w1 = fq.gauss_legendre(nq1)
    W = w1
    for _ in range(d - 1):
        W = np.kron(w1, W)
    h1b = fb.h1_gl_basis(opt.order_v, nq1)
    l2b = fb.l2_bernstein_basis(opt.order_e, nq1)

    rho_b = hydro.compute_density(S).detach().cpu().numpy()   # (NE, ld)
    x_e = (S["x"].detach().cpu().numpy()[:, hydro.h1.gather]
           .transpose(1, 0, 2))

    # positions and detJ at the error-rule points
    NE = hydro.NE
    xt = x_e.reshape((NE, d) + (hydro.nd1,) * d)
    for k in range(d):
        ax = xt.ndim - 1 - k
        xt = np.moveaxis(np.tensordot(xt, h1b.B, axes=[[ax], [1]]), -1, ax)
    xq = np.moveaxis(xt.reshape(NE, d, -1), 1, 2)        # (NE, NQ, d)
    J = qop.jacobians(torch.tensor(x_e), torch.tensor(h1b.B),
                      torch.tensor(h1b.G), d).numpy()
    detJ = np.linalg.det(J)

    rt = rho_b.reshape((NE,) + (hydro.l1d,) * d)
    for k in range(d):
        ax = rt.ndim - 1 - k
        rt = np.moveaxis(np.tensordot(rt, l2b.B, axes=[[ax], [1]]), -1, ax)
    rho_sim = rt.reshape(NE, -1)

    sol = SedovSolution(d, 1.4, 1.0, blast_energy)
    sol.set_time(t_final)
    r = np.linalg.norm(xq - np.asarray(blast_position[:d])[None, None, :],
                       axis=-1)
    rho_ex, _, _ = sol.eval(r.ravel())
    rho_ex = rho_ex.reshape(NE, -1)
    err2 = np.sum(W[None, :] * detJ * (rho_ex - rho_sim) ** 2)
    return float(np.sqrt(err2))
