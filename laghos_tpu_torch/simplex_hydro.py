"""Lagrangian hydro on simplex meshes (triangles and tetrahedra) in PyTorch.

The simplex counterpart of hydro.py, ported from `laghos_tpu.simplex_hydro`:
no tensor structure, so every dof <-> q-point map is a full (NQ, nd) table,
the regime the reference reaches through MFEM's full-assembly path for
simplices.  Dimension-generic over 2D triangles and 3D tetrahedra (the
reference's TRIANGLE/TETRAHEDRON geometry-switch entries), every problem
of problems.py (the Taylor-Green energy source and the Rayleigh-Taylor
gravity included), RK4 and RK2Avg (-s 7), one coupled Jacobi-PCG over all
velocity components through the matrix-free mass, and the energy update
through the inverted element L2 mass matrices (laghos_solver.cpp:400-439).

The static data is built once on the host in NumPy, as in the JAX package,
then copied to the run's device (the card unless the caller asks for the
CPU).  The q-update is plain torch, as it is plain JAX there (no Pallas
kernel); its 3D eigen-solve and smallest singular value are the cyclic
Jacobi forms of ops/smallmat.py.  Assembly of the element vectors (the
velocity right-hand side, the mass apply in the CG, the constant
Rayleigh-Taylor source) goes through the dof -> (element, local dof)
incidence table summed in a fixed order (ops/mass.py), where the JAX
package scatter-adds, so two runs on the card are bitwise equal.
"""

from __future__ import annotations

import numpy as np
import torch

from . import problems
from .device import setup
from .fem import simplex as fsx
from .fem import simplex_mesh as fsm
from .fem.batched_la import det_inv
from .fem.quadrature import default_rule_order
from .hydro import _BLAST_POSITION
from .ops import mass as mop
from .ops import smallmat
from .ops.qupdate import smooth_step_01
from .solvers.cg import cg


class SimplexHydro:
    """Static data, operators and the adaptive-dt run of a simplex mesh
    (`fem.simplex_mesh.TriMesh` or `TetMesh`)."""

    def __init__(self, mesh, opt, dtype=torch.float64, device="cuda"):
        """Static data on `device` ("cuda", the default, or "cpu"),
        resolved by device.setup: without a card "cuda" raises."""
        self.device = setup(device)
        self.mesh = mesh
        self.opt = opt
        self.dtype = dtype
        npdt = np.float64 if dtype == torch.float64 else np.float32
        dim = self.dim = mesh.dim
        pb = opt.problem
        self.source, self.use_visc, self.use_vort = problems.problem_flags(
            pb, dim)
        order = default_rule_order(opt.order_v, opt.order_e, opt.order_q)
        if dim == 2:
            h1t = fsx.h1_tri_tables(opt.order_v, order)
            l2t = fsx.l2_tri_tables(opt.order_e, order)
            G = np.stack([h1t["Gx"], h1t["Gy"]], -1)
            sp = fsm.build_tri_h1(mesh, opt.order_v)
        else:
            h1t = fsx.h1_tet_tables(opt.order_v, order)
            l2t = fsx.l2_tet_tables(opt.order_e, order)
            G = np.stack([h1t["Gx"], h1t["Gy"], h1t["Gz"]], -1)
            sp = fsm.build_tet_h1(mesh, opt.order_v)
        W = h1t["quad"][-1]
        self.NQ = W.size
        # host copies at the run's precision (the setup arithmetic), as the
        # JAX package reads its device tables back
        Bh = h1t["B"].astype(npdt)
        Gh = G.astype(npdt)
        Blh = l2t["B"].astype(npdt)
        self.nd = Bh.shape[1]
        self.ld = Blh.shape[1]
        NE = self.NE = mesh.num_elems
        self.ndof = sp["ndof"]
        self.gather_np = sp["gather"]

        x0 = sp["coords"]                          # (ndof, dim)
        v0 = problems.v0(pb, x0, dim).copy()
        v0.T[sp["ess"]] = 0.0

        # L2 initial conditions at the lattice nodes -> Bernstein
        lat_nodes = l2t["nodes"]                   # (ld, dim) reference
        epos = np.einsum("nc,ecd->end", self._bary_shape(lat_nodes),
                         mesh.verts[mesh.elems])
        rho0n = problems.rho0(pb, epos, dim)
        e0n = problems.e0(pb, epos, dim)
        T = l2t["nodal_to_b"]
        rho0_b = rho0n @ T.T
        e_b = e0n @ T.T
        gamma_e = problems.gamma(
            pb, mesh.verts[mesh.elems].mean(axis=1), dim)

        # t=0 geometry
        x0_l = x0.T
        x0_e = x0_l[:, sp["gather"]].transpose(1, 0, 2)  # (NE, dim, nd)
        J0 = np.einsum("qib,eai->eqab", Gh, x0_e)
        detJ0, Jac0inv = det_inv(J0)
        if pb == 1 and opt.blast_energy > 0.0:
            # Sedov point blast, the simplex analog of MFEM's
            # ProjectDeltaCoefficient (laghos.cpp:597-616): a nodal delta
            # at the blast vertex in every element sharing it, nodal ->
            # Bernstein, scaled so the global integral is
            # blast_energy / 2^dim (hydro.py's convention)
            center = np.asarray(_BLAST_POSITION[:dim])
            d2 = np.linalg.norm(epos - center[None, None, :], axis=-1)
            hit = d2 < max(opt.delta_tol, 1e-10)
            if not hit.any():
                raise RuntimeError(
                    "Delta function could not be initialized (no L2 node "
                    "at the blast position)")
            e_b = hit.astype(np.float64) @ T.T
            integral = float((W[None, :] * (e_b @ Blh.T) * detJ0).sum())
            e_b *= (opt.blast_energy / 2**dim) / integral

        rho0_q = rho0_b @ Blh.T                    # (NE, NQ)
        rw = W[None, :] * rho0_q * detJ0
        vol = float((W[None, :] * detJ0).sum())
        # h0: edge of the right-corner simplex of the mean element volume,
        # over the order (the simplex analog of laghos_solver.cpp:257)
        if dim == 2:
            self.h0 = np.sqrt(2.0 * vol / NE) / opt.order_v
        else:
            self.h0 = (6.0 * vol / NE) ** (1.0 / 3.0) / opt.order_v

        # mass data: pointwise rho0 at the q-points of the initial mesh
        xq0 = np.einsum("qi,eai->eqa", Bh, x0_e)
        massD = (W[None, :] * problems.rho0(pb, xq0, dim)
                 * detJ0).astype(npdt)
        diag_e = np.einsum("qi,qi,eq->ei", Bh, Bh, massD)
        dg = np.zeros(self.ndof)
        np.add.at(dg, sp["gather"].reshape(-1), diag_e.reshape(-1))
        Me = np.einsum("qi,qj,eq->eij", Blh, Blh, massD)

        def dev(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), dtype=dt).to(
                self.device).contiguous()

        self.B, self.G, self.Bl = dev(Bh), dev(Gh), dev(Blh)
        self.W = dev(W)
        self.rw = dev(rw)
        self.massD = dev(massD)
        self.h1_dinv = dev(1.0 / dg)
        self.Me_inv = dev(np.linalg.inv(Me))
        self.Jac0inv = dev(Jac0inv)
        self.gamma_t = dev(gamma_e)
        self.gather = dev(sp["gather"], torch.long)
        self.ess = dev(sp["ess"], torch.bool)
        inc, msk = mop.build_incidence(sp["gather"], self.ndof)
        self._inc = dev(inc, torch.long)
        self._incmask = dev(msk)
        dinv = self.h1_dinv[None, :].expand(dim, -1)
        self._dinv = torch.where(self.ess, torch.ones_like(dinv),
                                 dinv).reshape(1, -1)

        # Rayleigh-Taylor gravity source B_g = Mv . g, g = (0, -1[, 0]):
        # constant in time in the Lagrangian frame (laghos_solver.hpp:
        # 219-231)
        self.rt_rhs = None
        if self.source == 2:
            g = torch.zeros((dim, self.ndof), dtype=dtype,
                            device=self.device)
            g[1] = -1.0
            self.rt_rhs = self._assemble(self._mass_e(g))

        self.S0 = {"x": dev(x0_l), "v": dev(v0.T), "e": dev(e_b)}
        self.qupdate_calls = 0
        self.h1_iters = 0           # CG iterations of the last run's
        self.dt = None              # accepted steps; its final dt

    @staticmethod
    def _bary_shape(nodes):
        """(ld, dim+1) barycentric weights in vertex-column order.

        The H1 numbering (build_{tri,tet}_h1) pairs reference coordinate
        x with vertex 0, y with vertex 1, ..., and 1-sum with the last
        vertex; the L2 node sampling uses the same element map."""
        lam_last = 1.0 - nodes.sum(axis=1)
        return np.concatenate([nodes, lam_last[:, None]], axis=1)

    # ------------------------------------------------------------------
    def _gathered(self, u):
        """(C, ndof) -> (NE, C, nd)."""
        return u[:, self.gather].transpose(0, 1)

    def _assemble(self, y_e):
        """(C, NE, nd) -> (C, ndof) through the incidence gather."""
        return mop.e_to_l_gather(y_e, self._inc, self._incmask)

    def _mass_e(self, u):
        """Element mass apply B^T (massD . (B u)) of (C, ndof): (C, NE,
        nd)."""
        q = torch.einsum("qi,cei->ceq", self.B, u[:, self.gather])
        return torch.einsum("qi,ceq->cei", self.B, q * self.massD[None])

    def _mass_apply(self, u):
        y = self._assemble(self._mass_e(u))
        return torch.where(self.ess, torch.zeros_like(y), y)

    def _qupdate(self, S):
        """(sJit (NE, NQ, dim, dim), dt_min) at state S."""
        self.qupdate_calls += 1
        d = self.dim
        x_e = self._gathered(S["x"])
        v_e = self._gathered(S["v"])
        J = torch.einsum("qib,eai->eqab", self.G, x_e)
        detJ = smallmat.det(J, d)
        Jinv = smallmat.inv(J, d, detJ)
        e_q = S["e"] @ self.Bl.T
        R = self.rw / (detJ * self.W[None, :])
        E = torch.clamp(e_q, min=0.0)
        g = self.gamma_t[:, None]
        P = (g - 1.0) * R * E
        cs = torch.sqrt(g * (g - 1.0) * E)
        eye = torch.eye(d, dtype=self.dtype, device=self.device)
        stress = -P[..., None, None] * eye
        visc = torch.zeros_like(R)
        if self.use_visc:
            dV = torch.einsum("qib,eai->eqab", self.G, v_e)
            sgrad = torch.einsum("...ab,...bk->...ak", dV, Jinv)
            vort_coeff = 1.0
            if self.use_vort:
                grad_norm = torch.sqrt(torch.sum(sgrad * sgrad,
                                                 dim=(-2, -1)))
                div_v = torch.abs(torch.einsum("...aa->...", sgrad))
                vort_coeff = torch.where(
                    grad_norm > 0.0,
                    div_v / torch.clamp(grad_norm, min=1e-300),
                    torch.ones_like(grad_norm))
            sym = 0.5 * (sgrad + sgrad.transpose(-2, -1))
            mu, ev = smallmat.sym_eig_smallest(sym, d)
            Jpi = torch.einsum("...ab,...bk->...ak", J, self.Jac0inv)
            ph = torch.einsum("...ab,...b->...a", Jpi, ev)
            h = (self.h0 * torch.sqrt(torch.sum(ph * ph, dim=-1))
                 / torch.sqrt(torch.sum(ev * ev, dim=-1)))
            visc = 2.0 * R * h * h * torch.abs(mu)
            eps = 1e-12
            visc = visc + (0.5 * R * h * cs * vort_coeff
                           * (1.0 - smooth_step_01(mu - 2 * eps, eps)))
            stress = stress + visc[..., None, None] * sym
        sv = smallmat.min_singular_value(J, d)
        h_min = sv / float(self.opt.order_v)
        ih = 1.0 / h_min
        idt = cs * ih + 2.5 * visc * ih * ih / R
        pos = idt > 0.0
        dtq = torch.where(pos, self.opt.cfl / torch.where(
            pos, idt, torch.ones_like(idt)), torch.full_like(idt, np.inf))
        dtq = torch.where(detJ < 0.0, torch.zeros_like(dtq), dtq)
        sJit = torch.einsum("...vk,...gk->...gv", stress, Jinv)
        sJit = sJit * (self.W[None, :] * detJ)[..., None, None]
        return sJit, torch.amin(dtq)

    def _taylor_source(self, S):
        """Taylor-Green manufactured energy forcing on the current mesh
        (laghos_solver.hpp:207-218; the X,Y-only form of hydro.py)."""
        x_e = self._gathered(S["x"])
        J = torch.einsum("qib,eai->eqab", self.G, x_e)
        detJ = smallmat.det(J, self.dim)
        xq = torch.einsum("qi,eai->eqa", self.B, x_e)
        X, Y = xq[..., 0], xq[..., 1]
        pi = np.pi
        fq = (3.0 / 8.0) * pi * (torch.cos(3 * pi * X) * torch.cos(pi * Y)
                                 - torch.cos(pi * X) * torch.cos(3 * pi * Y))
        integ = self.W[None, :] * detJ * fq
        return torch.einsum("qj,eq->ej", self.Bl, integ)

    def _solve_velocity(self, sJit):
        """Coupled velocity-mass CG from the stress q-data (the FA solver
        layout, laghos_solver.cpp:400-439): (dv, iterations)."""
        # rhs_i[vd] = -sum_q Ghat_g(i,q) sJit[g,vd](q) * 1_q
        one_q = torch.sum(self.Bl, dim=1)          # (NQ,)
        Fq = sJit * one_q[None, :, None, None]
        rhs = -self._assemble(torch.einsum("qig,eqgv->vei", self.G, Fq))
        if self.rt_rhs is not None:
            rhs = rhs + self.rt_rhs
        rhs = torch.where(self.ess, torch.zeros_like(rhs), rhs)

        def apply_flat(u):
            return self._mass_apply(u.reshape(self.dim, -1)).reshape(1, -1)

        res = cg(apply_flat, rhs.reshape(1, -1), self.opt.cg_tol,
                 self.opt.cg_max_iter, precond=lambda r: r * self._dinv)
        return res.x.reshape(self.dim, -1), res.iters[0]

    def _solve_energy(self, sJit, v, S):
        """Direct per-element L2 energy solve against velocity v."""
        dVq = torch.einsum("qig,eai->eqag", self.G, self._gathered(v))
        eq = torch.einsum("eqvg,eqgv->eq", dVq, sJit)
        e_rhs = torch.einsum("qj,eq->ej", self.Bl, eq)
        if self.source == 1:
            e_rhs = e_rhs + self._taylor_source(S)
        return torch.einsum("eij,ej->ei", self.Me_inv, e_rhs)

    def _mult(self, S):
        sJit, dtm = self._qupdate(S)
        dv, it = self._solve_velocity(sJit)
        de = self._solve_energy(sJit, S["v"], S)
        return {"x": S["v"], "v": dv, "e": de}, dtm, it

    def _advance(self, S, dt):
        """One step: (S_new, dt_est, velocity CG iterations)."""
        if self.opt.ode_solver == 7:
            return self._rk2avg(S, dt)

        def ax(a, c, b):
            return {k: a[k] + c * b[k] for k in a}

        k1, m1, i1 = self._mult(S)
        y = ax(S, dt / 2, k1)
        k2, m2, i2 = self._mult(y)
        y = ax(S, dt / 2, k2)
        k3, m3, i3 = self._mult(y)
        y = ax(S, dt, k3)
        k4, m4, i4 = self._mult(y)
        S_new = {k: S[k] + dt / 6.0 * (k1[k] + 2 * k2[k] + 2 * k3[k]
                                       + k4[k]) for k in S}
        _, m5 = self._qupdate(S_new)
        return (S_new, torch.minimum(torch.minimum(m2, m3),
                                     torch.minimum(m4, m5)),
                i1 + i2 + i3 + i4)

    def _rk2avg(self, S, dt):
        """Energy-conserving two-stage average scheme (RK2Avg, -s 7;
        laghos_solver.cpp:1447-1487): the energy equation is driven by the
        stage-averaged velocity V = v0 + dt/2 dv, so IE+KE drift stays at
        round-off for source-free problems."""
        v0 = S["v"]

        def stage(Scur):
            sJit, dtm = self._qupdate(Scur)
            dv, it = self._solve_velocity(sJit)
            V = v0 + 0.5 * dt * dv
            de = self._solve_energy(sJit, V, Scur)
            return {"x": V, "v": dv, "e": de}, dtm, it

        d1, _, i1 = stage(S)
        Smid = {k: S[k] + 0.5 * dt * d1[k] for k in S}
        d2, m2, i2 = stage(Smid)
        S_new = {k: S[k] + dt * d2[k] for k in S}
        _, m3 = self._qupdate(S_new)
        return S_new, torch.minimum(m2, m3), i1 + i2

    def energies(self, S):
        """(internal, kinetic) energy with the mass weights massD (the
        Lagrangian-frame invariant mass), 0-d tensors: the total the
        scheme conserves semi-discretely."""
        vq = torch.einsum("qi,dei->deq", self.B, S["v"][:, self.gather])
        ke = 0.5 * torch.sum(self.massD * torch.sum(vq * vq, dim=0))
        eq = torch.einsum("qi,ei->eq", self.Bl, S["e"])
        return torch.sum(self.massD * eq), ke

    def run(self, t_final, max_steps=-1, verbose=False):
        """The adaptive-dt host loop of `laghos_tpu.simplex_hydro.
        SimplexHydro.run` (laghos.cpp:741-790): returns (S, t, steps) and
        leaves the final dt in `self.dt` and the velocity CG iterations of
        the accepted steps in `self.h1_iters`."""
        npdt = np.float64 if self.dtype == torch.float64 else np.float32
        S = self.S0
        t = 0.0
        dt = float(self._qupdate(S)[1])
        steps = 0
        ti = 1
        h1_iters = 0
        last = False
        while not last:
            if t + dt >= t_final:
                dt = t_final - t
                last = True
            if steps == max_steps:
                last = True
            S_old, t_old = S, t
            # dt in the state's precision, as the JAX package passes it
            S_new, dt_est, it = self._advance(S, float(npdt(dt)))
            steps += 1
            dt_est = float(dt_est)
            if dt_est < dt:
                dt *= 0.85
                S, t = S_old, t_old
                if steps < max_steps:
                    last = False
                continue
            S = S_new
            t += dt
            h1_iters = h1_iters + it
            if dt_est > 1.25 * dt:
                dt *= 1.02
            if verbose and ti % 10 == 0:
                en = float(torch.sqrt(torch.sum(S["e"] * S["e"])))
                print(f"step {ti:5d}, t = {t:.4f}, dt = {dt:.6f}, "
                      f"|e| = {en:.10e}")
            ti += 1
        self.dt, self.h1_iters = dt, int(h1_iters)
        return S, t, ti - 1


# The 2D-only name the JAX package's class started as.
TriHydro = SimplexHydro
