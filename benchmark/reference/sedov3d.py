"""Plain PyTorch reference of Laghos's 3D Sedov blast on a uniform cube.

The semantics of the reference Laghos (laghos.cpp, laghos_solver.cpp),
written out from its equations and independent of the package under test:
Q_p-Q_(p-1) elements (Gauss-Lobatto nodal H1 for position and velocity,
Bernstein L2 for the specific internal energy), Gauss-Legendre quadrature
of order 3 p_v + p_e - 1, the Sedov point blast deposited at the origin by
the delta projection, the q-point physics of UpdateQuadratureData (ideal
gas, the compression-based artificial viscosity, the CFL estimate), the
force pair F . 1 and F^T . v, the H1 and L2 mass solves, the RK2Avg
scheme and the adaptive dt control (rejection with 0.85, growth by 1.02).

It covers the configurations it is written for, nothing else: problem 1
on [0, 1]^3 cut into n^3 equal cubes, rho0 = 1, gamma = 1.4, so every
element has the same t = 0 geometry and the same mass matrices.  The mass
solves are tighter than the program's: a Jacobi-PCG on the assembled H1
mass to a relative (r, z) of 1e-28 (1e-14 on the norm), and the L2 mass
inverted element by element.  Numbering follows the lattice convention of
Laghos's structured meshes: H1 nodes on an (L, L, L) lattice, L = n p + 1,
x fastest; elements in raster order, x fastest; local dofs and q-points
x fastest.

Everything runs in float64 on the device it is given, in blocks of
elements, so that a large mesh fits beside nothing else.
"""

from __future__ import annotations

import math

import numpy as np
import torch

GAMMA = 1.4          # Sedov's ideal gas (laghos.cpp problem 1)
VISC_EPS = 1e-12     # the smooth step's width (laghos_solver.cpp)
CG_TOL = 1e-14       # the reference's own velocity solve
CG_MAX = 1000
MAX_REJECTS = 40


def build(config, blast_energy, device):
    """The reference problem of a configuration file's keys."""
    if (config["problem"], config["dim"], config["mesh"]) != (
            1, 3, "cube01_hex"):
        raise ValueError("sedov3d covers 3D Sedov on cube01_hex only")
    return Sedov3D(elements_per_axis=config["sizes"]["elements_per_axis"],
                   order_v=config["order_v"], order_e=config["order_e"],
                   cfl=config["cfl"], blast_energy=blast_energy,
                   device=device)


def gauss_legendre(n):
    """n Gauss-Legendre points and weights on [0, 1]."""
    x, w = np.polynomial.legendre.leggauss(n)
    return (x + 1.0) / 2.0, w / 2.0


def gauss_lobatto(n):
    """n Gauss-Lobatto points on [0, 1]: the endpoints and the roots of
    P'_(n-1)."""
    inner = np.polynomial.legendre.Legendre.basis(n - 1).deriv().roots()
    return (np.concatenate([[-1.0], np.sort(inner.real), [1.0]]) + 1.0) / 2.0


def lagrange(nodes, pts):
    """Values B[q, i] and derivatives G[q, i] of the Lagrange polynomials on
    `nodes` at `pts`, from the product formula."""
    n = len(nodes)
    B = np.ones((len(pts), n))
    G = np.zeros((len(pts), n))
    for i in range(n):
        others = [j for j in range(n) if j != i]
        den = np.prod([nodes[i] - nodes[j] for j in others])
        for j in others:
            B[:, i] *= (pts - nodes[j])
            term = np.ones(len(pts))
            for k in others:
                if k != j:
                    term *= (pts - nodes[k])
            G[:, i] += term
        B[:, i] /= den
        G[:, i] /= den
    return B, G


def bernstein(p, pts):
    """Bernstein polynomials C(p, i) t^i (1 - t)^(p - i) at `pts`."""
    return np.stack([math.comb(p, i) * pts ** i * (1.0 - pts) ** (p - i)
                     for i in range(p + 1)], axis=1)


def _tensor3(a, b, c):
    """(q, i) tables of a product a(x) b(y) c(z), x fastest on both
    indices."""
    return np.einsum("zk,yj,xi->zyxkji", c, b, a).reshape(
        a.shape[0] * b.shape[0] * c.shape[0], -1)


def _det_inv3(J):
    """Determinants and inverses of (..., 3, 3) matrices by the
    adjugate."""
    a = lambda i, j: J[..., i, j]  # noqa: E731
    c = torch.stack([
        torch.stack([a(1, 1) * a(2, 2) - a(1, 2) * a(2, 1),
                     a(0, 2) * a(2, 1) - a(0, 1) * a(2, 2),
                     a(0, 1) * a(1, 2) - a(0, 2) * a(1, 1)], -1),
        torch.stack([a(1, 2) * a(2, 0) - a(1, 0) * a(2, 2),
                     a(0, 0) * a(2, 2) - a(0, 2) * a(2, 0),
                     a(0, 2) * a(1, 0) - a(0, 0) * a(1, 2)], -1),
        torch.stack([a(1, 0) * a(2, 1) - a(1, 1) * a(2, 0),
                     a(0, 1) * a(2, 0) - a(0, 0) * a(2, 1),
                     a(0, 0) * a(1, 1) - a(0, 1) * a(1, 0)], -1)], -2)
    det = a(0, 0) * c[..., 0, 0] + a(0, 1) * c[..., 1, 0] + a(0, 2) * c[
        ..., 2, 0]
    return det, c / det[..., None, None]


def eigh3(A, sweeps=30):
    """Eigenvalues (ascending) and eigenvectors (columns) of symmetric
    (..., 3, 3) matrices by cyclic Jacobi rotations, run until the
    off-diagonal part is at round-off of the whole (its squares below
    1e-30 of the squared Frobenius norm)."""
    A = A.clone()
    V = torch.eye(3, dtype=A.dtype, device=A.device).expand_as(A).clone()
    scale = A.square().sum((-1, -2))

    def rotate(M, c, s, p, q, rows):
        """M <- M R (columns p, q) or R^T M (rows p, q), R the rotation
        with R_pp = R_qq = c, R_pq = s, R_qp = -s."""
        take = (lambda k: M[..., k, :]) if rows else (lambda k: M[..., :, k])
        mp, mq = take(p).clone(), take(q).clone()
        take(p).copy_(c[..., None] * mp - s[..., None] * mq)
        take(q).copy_(s[..., None] * mp + c[..., None] * mq)

    for _ in range(sweeps):
        off = (A[..., 0, 1] ** 2 + A[..., 0, 2] ** 2 + A[..., 1, 2] ** 2)
        if not bool((off > 1e-30 * scale).any()):
            break
        for p, q in ((0, 1), (0, 2), (1, 2)):
            apq = A[..., p, q]
            zero = apq == 0
            theta = (A[..., q, q] - A[..., p, p]) / torch.where(
                zero, 1.0, 2.0 * apq)
            t = torch.sign(theta) / (theta.abs() + torch.sqrt(
                theta * theta + 1.0))
            t = torch.where(zero | ~torch.isfinite(t), 0.0,
                            torch.where(theta == 0, 1.0, t))
            c = 1.0 / torch.sqrt(t * t + 1.0)
            s = t * c
            rotate(A, c, s, p, q, rows=False)
            rotate(A, c, s, p, q, rows=True)
            rotate(V, c, s, p, q, rows=False)
    lam = torch.diagonal(A, dim1=-2, dim2=-1)
    lam, order = torch.sort(lam, dim=-1)
    return lam, torch.gather(V, -1, order[..., None, :].expand_as(V))


def _smooth_step(x, eps):
    """laghos_solver.cpp's smooth_step_01."""
    y = torch.clamp((x + eps) / (2.0 * eps), 0.0, 1.0)
    return (3.0 - 2.0 * y) * y * y


class Sedov3D:
    """The discrete Sedov problem of one configuration; its methods are
    the reference's step and its pieces."""

    def __init__(self, *, elements_per_axis, order_v, order_e, cfl,
                 blast_energy, device="cpu", block_points=1 << 23):
        self.dev = torch.device(device)
        f64 = torch.float64
        n, p, pe = elements_per_axis, order_v, order_e
        self.n, self.p, self.pe = n, p, pe
        self.cfl = cfl
        self.E0 = blast_energy
        nq1 = (3 * p + pe - 1) // 2 + 1
        self.nq1, self.Q = nq1, nq1 ** 3
        self.nd, self.ld = (p + 1) ** 3, (pe + 1) ** 3
        self.NE = n ** 3
        self.L = n * p + 1
        self.N = self.L ** 3
        self.h = 1.0 / n
        self.h0 = self.h / p
        qx, qw = gauss_legendre(nq1)
        gll = gauss_lobatto(p + 1)
        B1, G1 = lagrange(gll, qx)
        Bl1 = bernstein(pe, qx)
        W = np.einsum("k,j,i->kji", qw, qw, qw).reshape(-1)
        B3 = _tensor3(B1, B1, B1)
        G3 = np.stack([_tensor3(G1, B1, B1), _tensor3(B1, G1, B1),
                       _tensor3(B1, B1, G1)])
        Bl3 = _tensor3(Bl1, Bl1, Bl1)
        t = lambda a: torch.tensor(a, dtype=f64, device=self.dev)  # noqa
        self.W, self.B3, self.G3, self.Bl3 = t(W), t(B3), t(G3), t(Bl3)
        vol = self.h ** 3
        # rho0 = 1 and the t = 0 Jacobian h I on every element: the same
        # element mass matrices everywhere
        self.rw = self.W * vol                         # rho0 detJ0 w
        self.Mh1 = t(vol * B3.T @ (W[:, None] * B3))
        self.Ml2_inv = torch.linalg.inv(t(vol * Bl3.T @ (W[:, None] * Bl3)))

        # element -> lattice node map
        ex = torch.arange(n, device=self.dev)
        a = torch.arange(p + 1, device=self.dev)
        L = self.L
        ez, ey, exx = torch.meshgrid(ex, ex, ex, indexing="ij")
        az, ay, axx = torch.meshgrid(a, a, a, indexing="ij")
        self.conn = (((ez.reshape(-1, 1) * p + az.reshape(1, -1)) * L
                      + ey.reshape(-1, 1) * p + ay.reshape(1, -1)) * L
                     + exx.reshape(-1, 1) * p + axx.reshape(1, -1))
        diag = torch.zeros(self.N, dtype=f64, device=self.dev)
        diag.index_add_(0, self.conn.reshape(-1),
                        torch.diagonal(self.Mh1).repeat(self.NE))
        self.dinv = 1.0 / diag
        # boundary attribute c + 1 fixes velocity component c on the two
        # faces normal to axis c (laghos.cpp)
        k = torch.arange(L, device=self.dev)
        edge = (k == 0) | (k == L - 1)
        ones = torch.ones(L, dtype=torch.bool, device=self.dev)
        self.ess = torch.stack([
            (ones[:, None, None] & ones[None, :, None] & edge[None, None, :]),
            (ones[:, None, None] & edge[None, :, None] & ones[None, None, :]),
            (edge[:, None, None] & ones[None, :, None] & ones[None, None, :]),
        ]).reshape(3, -1)
        self.eb = max(1, block_points // self.Q)

        # lattice coordinates: the multilinear map of each element at the
        # Gauss-Lobatto points
        e1 = np.minimum(np.arange(L) // p, n - 1)
        s1 = gll[np.arange(L) - e1 * p]
        X1 = t(e1 * self.h * (1.0 - s1) + (e1 + 1) * self.h * s1)
        Xz, Xy, Xx = torch.meshgrid(X1, X1, X1, indexing="ij")
        self.x0 = torch.stack([Xx.reshape(-1), Xy.reshape(-1),
                               Xz.reshape(-1)])
        self.e0 = self._sedov_energy(qx, qw)

    # ------------------------------------------------------- set-up ----
    def _sedov_energy(self, qx, qw):
        """The delta projection of the blast energy at the origin vertex
        (laghos.cpp): on its one element the nodal L2 polynomial
        (1 - t)^p_e per axis at the Gauss-Legendre nodes, scaled so that
        its integral is E0 / 8, then written in the Bernstein basis."""
        pe = self.pe
        g, _ = gauss_legendre(pe + 1)
        d1 = (1.0 - g) ** pe
        nodal = np.einsum("k,j,i->kji", d1, d1, d1).reshape(-1)
        Ln, _ = lagrange(g, qx)
        at_q = _tensor3(Ln, Ln, Ln) @ nodal
        W = np.einsum("k,j,i->kji", qw, qw, qw).reshape(-1)
        integral = float(np.sum(W * self.h ** 3 * at_q))
        nodal = nodal * ((self.E0 / 8.0) / integral)
        Vinv = np.linalg.inv(bernstein(pe, g))       # nodal -> Bernstein
        coef = np.einsum("ck,bj,ai,kji->cba", Vinv, Vinv, Vinv,
                         nodal.reshape(pe + 1, pe + 1, pe + 1)).reshape(-1)
        e0 = torch.zeros(self.NE, self.ld, dtype=torch.float64,
                         device=self.dev)
        e0[0] = torch.tensor(coef, dtype=torch.float64, device=self.dev)
        return e0

    def initial_state(self):
        return {"x": self.x0.clone(), "v": torch.zeros_like(self.x0),
                "e": self.e0.clone()}

    # ---------------------------------------------------- operators ----
    def _blocks(self):
        for lo in range(0, self.NE, self.eb):
            yield slice(lo, min(lo + self.eb, self.NE))

    def qupdate(self, S):
        """UpdateQuadratureData: (sJ (NE, Q, 3, 3) with sJ[.., vd, gd] =
        (stress J^-T)[vd, gd] w detJ, the minimum dt estimate)."""
        sJ = torch.empty(self.NE, self.Q, 3, 3, dtype=torch.float64,
                         device=self.dev)
        dt_min = math.inf
        for b in self._blocks():
            c = self.conn[b]
            J = torch.einsum("aei,bqi->eqab", S["x"][:, c], self.G3)
            dV = torch.einsum("aei,bqi->eqab", S["v"][:, c], self.G3)
            e_q = S["e"][b] @ self.Bl3.T
            detJ, Jinv = _det_inv3(J)
            if not bool(torch.isfinite(detJ).all()) or bool((detJ < 0).any()):
                dt_min = 0.0
            rho = self.rw / (detJ * self.W)
            E = torch.clamp(e_q, min=0.0)
            p = (GAMMA - 1.0) * rho * E
            cs = torch.sqrt(GAMMA * (GAMMA - 1.0) * E)
            gv = dV @ Jinv
            sym = 0.5 * (gv + gv.transpose(-1, -2))
            lam, vec = eigh3(sym)
            mu, cdir = lam[..., 0], vec[..., :, 0]
            ph = (J / self.h) @ cdir[..., None]          # J Jac0inv dir
            hq = self.h0 * ph[..., 0].norm(dim=-1) / cdir.norm(dim=-1)
            visc = 2.0 * rho * hq * hq * mu.abs()
            visc = visc + 0.5 * rho * hq * cs * (
                1.0 - _smooth_step(mu - 2.0 * VISC_EPS, VISC_EPS))
            eye = torch.eye(3, dtype=torch.float64, device=self.dev)
            stress = -p[..., None, None] * eye + visc[..., None, None] * sym
            sv = torch.sqrt(torch.clamp(eigh3(
                J.transpose(-1, -2) @ J)[0][..., 0], min=0.0))
            hmin = sv / self.p
            inv_dt = cs / hmin + 2.5 * visc / rho / (hmin * hmin)
            pos = inv_dt > 0
            if bool(pos.any()):
                dt_min = min(dt_min, float(
                    (self.cfl / inv_dt[pos]).min()))
            sJ[b] = (stress @ Jinv.transpose(-1, -2)) * (
                self.W * detJ)[..., None, None]
        return sJ, dt_min

    def force_one(self, sJ):
        """F . 1 on the H1 lattice, (3, N)."""
        out = torch.zeros(3, self.N, dtype=torch.float64, device=self.dev)
        for b in self._blocks():
            Fe = torch.einsum("eqvg,gqi->vei", sJ[b], self.G3)
            out.index_add_(1, self.conn[b].reshape(-1), Fe.reshape(3, -1))
        return out

    def force_transpose(self, sJ, v):
        """F^T . v, (NE, ld)."""
        out = torch.empty(self.NE, self.ld, dtype=torch.float64,
                          device=self.dev)
        for b in self._blocks():
            dV = torch.einsum("aei,gqi->eqag", v[:, self.conn[b]], self.G3)
            out[b] = (dV * sJ[b]).sum(dim=(-1, -2)) @ self.Bl3
        return out

    def mass_h1(self, u):
        """The assembled H1 mass on each of the rows of u, (C, N); rows
        and columns of the essential dofs left out."""
        u = torch.where(self.ess, 0.0, u)
        out = torch.zeros_like(u)
        for b in self._blocks():
            c = self.conn[b]
            out.index_add_(1, c.reshape(-1),
                           (u[:, c] @ self.Mh1).reshape(u.shape[0], -1))
        return torch.where(self.ess, 0.0, out)

    def solve_velocity(self, sJ):
        """M_v dv = -F . 1 with the essential dofs held at 0: Jacobi-PCG on
        each component to a relative (r, z) of CG_TOL^2."""
        b = torch.where(self.ess, 0.0, -self.force_one(sJ))
        x = torch.zeros_like(b)
        r = b
        z = r * self.dinv
        d = z
        nom = (r * z).sum(-1)
        target = nom * CG_TOL ** 2
        for _ in range(CG_MAX):
            active = nom > target
            if not bool(active.any()):
                break
            Ad = self.mass_h1(d)
            den = (d * Ad).sum(-1)
            alpha = torch.where(active, nom / torch.where(den > 0, den, 1.0),
                                0.0)
            x = x + alpha[:, None] * d
            r = r - alpha[:, None] * Ad
            z = r * self.dinv
            new = (r * z).sum(-1)
            beta = new / torch.where(nom > 0, nom, 1.0)
            d = torch.where(active[:, None], z + beta[:, None] * d, d)
            nom = torch.where(active, new, nom)
        return x

    def solve_energy(self, sJ, v):
        """M_e de = F^T . v, element by element (the L2 mass is block
        diagonal)."""
        return self.force_transpose(sJ, v) @ self.Ml2_inv

    # ---------------------------------------------------- stepping -----
    def attempt(self, S, dt):
        """One RK2Avg step (laghos_solver.cpp RK2AvgSolver::Step): the new
        state and the dt estimates of its three q-updates (start, middle,
        end)."""
        v0 = S["v"]

        def stage(Sc):
            sJ, dtq = self.qupdate(Sc)
            dv = self.solve_velocity(sJ)
            V = v0 + 0.5 * dt * dv
            de = self.solve_energy(sJ, V)
            return {"x": V, "v": dv, "e": de}, dtq

        dS, d1 = stage(S)
        mid = {k: S[k] + 0.5 * dt * dS[k] for k in S}
        dS, d2 = stage(mid)
        new = {k: S[k] + dt * dS[k] for k in S}
        _, d3 = self.qupdate(new)
        finite = all(bool(torch.isfinite(new[k]).all()) for k in new)
        return new, (d1, d2, d3) if finite else (0.0, 0.0, 0.0)

    def step(self, S, dt, after_reject=False):
        """The driver's step from S at the proposed dt (laghos.cpp's main
        loop): attempts with dt *= 0.85 until the estimate allows the dt.
        Returns (the accepted state, its dt, its estimate, the number of
        rejected attempts).  The estimate counts the start of the step only
        after a rejection, where the step recomputes it; otherwise the
        previous step's end stands for it."""
        rejects = 0
        while True:
            new, (d1, d2, d3) = self.attempt(S, dt)
            est = min(d2, d3, d1) if after_reject else min(d2, d3)
            if est >= dt:
                return new, dt, est, rejects
            rejects += 1
            if rejects > MAX_REJECTS:
                raise RuntimeError("the reference's time step crashed")
            dt *= 0.85
            after_reject = True

    @staticmethod
    def next_dt(dt, est):
        """The dt proposed after an accepted step (laghos.cpp)."""
        return dt * 1.02 if est > 1.25 * dt else dt
