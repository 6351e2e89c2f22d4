"""AMR hydrodynamics operator: conforming solve on a hanging-node forest.

The port of `laghos_tpu.amr.solver`, with the reference AMR variant's
semantics (amr/laghos_solver.cpp):
  * full-assembly-style solves (direct per-element energy mass inverse,
    coupled velocity CG) — the variant is FA-only (amr/laghos.cpp:219-227),
  * hard `if (mu < 0)` viscosity switch (amr/laghos_solver.cpp:610), no
    vorticity term,
  * per-element h0 scaling by 2^-depth (amr/laghos_solver.cpp:598-604),
  * per-zone max artificial viscosity as the refinement estimator
    (amr/laghos_solver.cpp:644-647).

State lives in TRUE dofs; the hanging-node interpolation P expands to the
full node set before element gathers, and P^T folds residuals back — the
equivalent of MFEM's conforming prolongation inside CG.

Where the port departs from the JAX package:
  * no scatter on the step path.  The JAX package applies P^T and
    assembles element vectors with scatter-adds (`.at[].add`), which on
    the card would be atomics whose order, and so whose last bits, change
    from run to run.  Here every rebuild tabulates, in NumPy, P (each node
    as a copy of its true dof or its slave's master row), P^T (each true
    dof's own node plus its (slave, weight) pairs in a fixed order) and the
    node -> (element, local node) incidence (`ops/mass.build_incidence`);
    all three apply as gathers summed in a fixed order, so two runs on the
    card are bitwise equal;
  * no capacity padding.  The JAX package pads every array to multiples of
    64 (dead node and true slots, `elem_valid` masks) so that XLA does not
    retrace at each mesh change; eager PyTorch has nothing to retrace, so
    each rebuild makes unpadded tensors;
  * the velocity CG is unpreconditioned, so the Jacobi diagonal the JAX
    package builds at each rebuild (and never reads) is not built;
  * the refinement indicators (the zone-max viscosity, min |v|, max
    density, the blast-vertex test and |e|) are computed on the state's
    device, and `indicators` copies them to the host in one transfer;
  * each rebuild makes its arrays on the host and then places them on the
    device (`_place`): all of them, or, over a rank group
    (`parallel.sharding.shard_amr`), through the `_on_rebuild` callback,
    one rank's contiguous element chunk and the whole node and true-dof
    data.  The hook points that cross ranks (`_ranks_sum` after P^T, the dt
    minimum in `qupdate`, `e_norm`, the indicators' gather and
    `global_state`) are the identity without a rank group (`comm` None).

The q-update is plain torch, as it is plain JAX in the JAX package: the
AMR path launches none of the hand-written kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import setup
from ..fem import basis as fb
from ..fem import quadrature as fq
from ..ops import force as fop
from ..ops import mass as mop
from ..ops import qupdate as qop
from ..ops import smallmat
from ..ops import tensor as top
from ..solvers.cg import cg


def _lattice(n, d):
    """(n^d, d) multi-indices of a tensor lattice, x fastest."""
    grids = np.meshgrid(*([np.arange(n)] * d), indexing="ij")
    return np.stack([g.reshape(-1, order="F") for g in grids], axis=1)


def _gauss_table(nodes1d, int_order):
    """Values at the Gauss points of MFEM's IntRules order `int_order`
    (Gauss rules are exact to 2n-1, built with n = order/2 + 1) of the 1D
    Lagrange basis on `nodes1d`: (npts, len(nodes1d))."""
    pts, _ = fq.gauss_legendre(int_order // 2 + 1)
    B, _ = fb.lagrange_tables(np.asarray(nodes1d), pts)
    return B


class AMRHydro:
    """Sedov-blast hydrodynamics on an adaptive forest (problem 1)."""

    def __init__(self, forest, opt, dtype=torch.float64,
                 h0_zone_count=None, h0=None, ckpt=None, device="cuda"):
        """Operators of `forest` on `device` ("cuda", the default, or
        "cpu"), resolved by device.setup: without a card "cuda" raises.

        h0: explicit base length scale.  The reference AMR driver
        OVERRIDES the mesh-derived h0 with SetH0(0.5 / order_v)
        (amr/laghos.cpp "double elem_size = 0.5; oper.SetH0(...)"), 0.5
        being the base element size of square01_quad / cube01_hex;
        AMRUpdate never recomputes it.  h0_zone_count keeps the
        mesh-derived fallback (amr/laghos_solver.cpp:165-187) for forests
        not driven through the reference CLI semantics.  ckpt: a
        checkpoint dict of `driver.save_checkpoint` to resume from."""
        self.device = setup(device)
        self.forest = forest
        self.opt = opt
        self.h0_zone_count = h0_zone_count
        if h0 is not None:
            self._h0 = float(h0)
        self.dtype = dtype
        d = self.dim = forest.dim
        self.nd1 = opt.order_v + 1
        self.l1d = opt.order_e + 1
        self.ld = self.l1d**d
        ir_order = fq.default_rule_order(opt.order_v, opt.order_e,
                                         opt.order_q)
        nq1 = self.nq1 = fq.points_for_order(ir_order)
        self.NQ = nq1**d
        qpts, w1 = fq.gauss_legendre(nq1)
        W = w1
        for _ in range(d - 1):
            W = np.kron(w1, W)
        self.Wnp = W
        h1b = fb.h1_gl_basis(opt.order_v, nq1)
        # AMR uses the DEFAULT (Gauss-Legendre nodal) L2 basis, not
        # Bernstein: MFEM cannot derefine non-nodal bases, so the
        # reference AMR build comments out BasisType::Positive
        # (amr/laghos.cpp:329, amr/README "Limitations").  The reported
        # |e| norm is the dof-vector norm in this nodal basis.
        gln, _ = fq.gauss_legendre(opt.order_e + 1)
        l2B, _ = fb.lagrange_tables(gln, qpts)
        self.l2_nodes1d = gln
        host = {"H1B": h1b.B, "H1G": h1b.G, "L2B": l2B, "W": W}
        # setup arithmetic on the host at the run's precision
        self._host_tables = {k: torch.as_tensor(v, dtype=dtype)
                             for k, v in host.items()}
        self.tables = {k: self._dev(v) for k, v in host.items()}
        # Gauss-point tables of the refinement indicators
        # (GetPerElementMinMax, amr/laghos.cpp:826-866)
        self._vB = self._dev(_gauss_table(
            fq.gauss_lobatto(opt.order_v + 1), opt.order_v + 1))
        self._rB = self._dev(_gauss_table(gln, opt.order_e + 1))
        lat = _lattice(self.nd1, d)
        self._corners = torch.as_tensor(np.where(np.all(
            (lat == 0) | (lat == opt.order_v), axis=1))[0],
            device=self.device)
        self.h1order = float(opt.order_v)
        eps = np.finfo(np.float64).eps
        self.ftz_eps2 = eps * eps
        self.h1_iters = torch.zeros((), dtype=torch.long,
                                    device=self.device)
        self.h1_solves = 0          # velocity solves since construction
        self._cg_reads = [None]
        # distribution hooks: parallel.sharding.shard_amr sets the rank
        # group and a re-placement callback, so that every rebuild places
        # this rank's element chunk (the JAX package's device_mesh and
        # _on_rebuild)
        self.comm = None
        self._on_rebuild = None

        if ckpt is None:
            self._build_space_arrays()
            sp = self.space
            self.x0_T = sp["coords"][sp["true_ids"]].T      # (d, nt)
            state = (self.x0_T, np.zeros_like(self.x0_T),
                     self._initial_energy())
        else:
            # resume from a driver checkpoint: the history-dependent
            # pieces are the interpolated initial config x0_T (carried
            # through every AMR transfer), the frozen h0
            # (amr/laghos_solver.cpp:165-187; AMRUpdate never
            # recomputes it), and the current (x, v, e) state
            self.x0_T = np.asarray(ckpt["x0_T"], np.float64)
            self._h0 = float(ckpt["h0"])
            self._build_space_arrays()
            state = (ckpt["xT"], ckpt["vT"], ckpt["e"])
        self._rebuilt(self._build_geometry(), *state)

    def _dev(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype or self.dtype,
                               device=self.device).contiguous()

    def move_to(self, device):
        """Run on `device` from now on: the tables move there, and the
        next placement puts the mesh arrays and the state there."""
        self.device = device
        self.tables = {k: v.to(device) for k, v in self.tables.items()}
        self._vB, self._rB, self._corners, self.h1_iters = (
            t.to(device) for t in (self._vB, self._rB, self._corners,
                                   self.h1_iters))

    # ------------------------------------------------------------------
    def _build_space_arrays(self):
        sp = self.forest.build_space(self.opt.order_v)
        self.space = sp
        self.NE = self.forest.num_leaves
        self.nn = sp["nn"]
        self.nt = sp["true_ids"].size

    def _prolongation_tables(self):
        """P and P^T as gather tables (NumPy), unpadded.

        P: node n takes entry lmap[n] of [x_T, x_slaves], where x_slaves
        (Ns,) = sum_w weights[s, w] x_T[masters[s, w]].
        P^T: true dof t sums y[true_ids[t]] and y[pt_idx[t, k]] *
        pt_w[t, k] over its (slave node, weight) pairs, ordered by slave
        then by weight slot; unused slots index an appended zero node with
        weight 0."""
        sp = self.space
        nn, nt = self.nn, self.nt
        slave_ids, masters, weights = (sp["slave_ids"], sp["masters"],
                                       sp["weights"])
        lmap = np.empty(nn, dtype=np.int64)
        lmap[sp["true_ids"]] = np.arange(nt)
        lmap[slave_ids] = nt + np.arange(slave_ids.size)
        Ns, W = masters.shape
        s_of = np.repeat(np.arange(Ns), W)
        m_of = masters.reshape(-1)
        w_of = weights.reshape(-1)
        live = w_of != 0.0
        s_of, m_of, w_of = s_of[live], m_of[live], w_of[live]
        order = np.argsort(m_of, kind="stable")
        counts = np.bincount(m_of, minlength=nt)
        V = int(counts.max()) if counts.size else 0
        pt_idx = np.full((nt, V), nn, dtype=np.int64)
        pt_w = np.zeros((nt, V))
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        for v in range(V):
            sel = np.where(counts > v)[0]
            k = order[starts[sel] + v]
            pt_idx[sel, v] = slave_ids[s_of[k]]
            pt_w[sel, v] = w_of[k]
        return lmap, pt_idx, pt_w

    def _build_geometry(self):
        """Host (CPU) tensors of the current forest, all elements: the
        gathers, the P / P^T tables, t=0 geometry, mass data and depths
        (`_place` puts them on the device)."""
        d = self.dim
        sp = self.space
        NE = self.NE
        lmap, pt_idx, pt_w = self._prolongation_tables()
        ess_true = sp["ess"][:, sp["true_ids"]]

        # t=0 geometry on the (possibly interpolated) initial config
        x0_L = self._p_apply_np(np.asarray(self.x0_T))     # (d, nn)
        x0_e = x0_L[:, sp["gather"]].transpose(1, 0, 2)
        tb = self._host_tables
        J0 = qop.jacobians(torch.as_tensor(x0_e, dtype=self.dtype),
                           tb["H1B"], tb["H1G"], d).double().numpy()
        detJ0 = np.linalg.det(J0)
        Jac0inv = np.linalg.inv(J0)
        rw = self.Wnp[None, :] * detJ0                     # rho0 = 1
        # h0 = (area / zone count)^(1/d) / order, computed ONCE on the
        # initial (vertex-refined) mesh and frozen through all AMR events
        # (amr/laghos_solver.cpp:165-187; AMRUpdate does not recompute it)
        if not hasattr(self, "_h0"):
            vol = float(rw.sum())
            zc = self.h0_zone_count or NE
            self._h0 = (np.sqrt(vol / zc) if d == 2
                        else (vol / zc) ** (1.0 / 3.0)) / self.opt.order_v
        Me = mop.l2_mass_matrices(torch.as_tensor(rw, dtype=self.dtype),
                                  tb["L2B"], d).double().numpy()
        # element H1 mass matrices B^T diag(rho0 detJ0 w) B (constant in
        # time, as the reference's FA mass): one batched product an apply
        Bd = top.dense_ops(tb["H1B"], tb["H1G"], d)[0]     # (NQ, nd)
        Mv = np.matmul(Bd.T[None] * rw[:, None, :], Bd)
        L = torch.long
        host = {
            "gather": (sp["gather"], L),
            "lmap": (lmap, L),
            "true_ids": (sp["true_ids"], L),
            "masters": (sp["masters"], L),
            "weights": (sp["weights"], None),
            "pt_idx": (pt_idx, L),
            "pt_w": (pt_w, None),
            "ess_true": (ess_true, torch.bool),
            "rho0DetJ0w": (rw, None),
            "Mv": (Mv, None),
            "Jac0inv": (Jac0inv, None),
            "Me_inv": (np.linalg.inv(Me), None),
            "depths": (self.forest.depths(), None),
        }
        return {k: torch.as_tensor(np.asarray(a), dtype=dt or self.dtype)
                .contiguous() for k, (a, dt) in host.items()}

    def _place(self, host, xT, vT, e, lo=0, hi=None):
        """Put the host arrays of `_build_geometry` and the state on the
        device: the element-axis arrays (ELEMENT_KEYS) and the energy for
        elements [lo, hi) of the leaf order (default: all), the node and
        true-dof data whole, and the node -> (element, local node)
        incidence of those elements."""
        hi = self.NE if hi is None else hi
        self.elements = (lo, hi)
        ctx = {k: (v[lo:hi] if k in ELEMENT_KEYS else v).to(self.device)
               for k, v in host.items()}
        inc, msk = mop.build_incidence(host["gather"][lo:hi].numpy(),
                                       self.nn)
        ctx["inc"] = self._dev(inc, torch.long)
        ctx["inc_mask"] = self._dev(msk)
        self.ctx = ctx
        self.state = self.make_state(xT, vT, e)
        self._cg_reads = [None]

    def _rebuilt(self, host, xT, vT, e):
        """Place a build (host arrays, the global state): all of it, or
        through the callback of `parallel.sharding.shard_amr`."""
        if self._on_rebuild is None:
            self._place(host, xT, vT, e)
        else:
            self._on_rebuild(host, xT, vT, e)

    def make_state(self, xT, vT, e):
        """State dict on the device of (d, nt) / (NE, ld) global host
        arrays: x and v whole, the energy of this process's elements."""
        lo, hi = self.elements
        return {"x": self._dev(xT), "v": self._dev(vT),
                "e": self._dev(np.asarray(e)[lo:hi])}

    def global_state(self):
        """(xT, vT, e) of the whole mesh as float64 NumPy arrays; over
        ranks a collective (the energy chunks all-gathered in rank
        order)."""
        xT, vT, e = (self.state[k].double().cpu().numpy()
                     for k in ("x", "v", "e"))
        if self.comm is not None:
            e = np.concatenate(self._gather_chunks(e, lambda n: (n, self.ld)))
        return xT, vT, e

    def _gather_chunks(self, a, shape_of):
        """Every rank's float64 array `a` of its element chunk, in rank
        order, in one collective; raises ValueError unless rank r's has the
        shape `shape_of(n_r)`, n_r being r's share of the current NE."""
        parts = self.comm.all_gather(np.ascontiguousarray(a))
        D, NE = self.comm.size, self.NE
        for r, p in enumerate(parts):
            want = shape_of((r + 1) * NE // D - r * NE // D)
            if p.dtype != np.float64 or p.shape != want:
                raise ValueError(
                    f"rank {self.comm.rank}: rank {r} sent a {p.dtype} "
                    f"{p.shape} chunk, expected float64 {want} (NE {NE})")
        return parts

    def _one_rank(self):
        return self.comm is None or self.comm.size == 1

    def _ranks_sum(self, yT):
        """The sum over the ranks of a partial true vector (the identity on
        one rank): each rank assembles its chunk's elements only."""
        return yT if self._one_rank() else self.comm.allreduce_sum(yT)

    # ------------------------------------------------------------------
    def _initial_energy(self):
        """Delta blast at the origin corner.

        NOTE: unlike main laghos.cpp:601-604 (which passes
        blast_energy / 2^dim to DeltaCoefficient, "due to simulating
        only a portion of the symmetric blast"), the AMR variant passes
        blast_energy UNSCALED (amr/laghos.cpp:417-421, fixed 0.25) — so
        the projected delta integrates to the full 0.25."""
        d = self.dim
        opt = self.opt
        e = np.zeros((self.NE, self.ld))
        gl_nodes, _ = fq.gauss_legendre(opt.order_e + 1)
        # the corner leaf: the one containing the origin
        corner = None
        for li, (k, idx) in enumerate(self.forest.leaf_list()):
            if all(v == 0 for v in idx):
                corner = li
                depth = k
        assert corner is not None
        p = opt.order_e
        vals1 = (1.0 - gl_nodes) ** p
        lat = _lattice(p + 1, d)
        vals = np.ones(self.ld)
        for n in range(self.ld):
            for dd in range(d):
                vals[n] *= vals1[lat[n, dd]]
        # integral of the delta polynomial over the corner leaf
        size = [self.forest.sizes[k] / self.forest.base_n[k] / (1 << depth)
                for k in range(d)]
        integral = np.prod(size) / (p + 1) ** d
        scale = opt.blast_energy / integral
        # nodal GL basis: the ProjectDelta polynomial values at the nodes
        # ARE the dofs (no change of basis; the AMR build does not use
        # the Positive basis, amr/laghos.cpp:414-427)
        e[corner] = vals * scale
        return e

    # ---------------- step operators (device tensors) -------------------
    def _p_apply(self, xT):
        """true (C, nt) -> full nodes (C, nn), by gathers."""
        ctx = self.ctx
        if ctx["masters"].shape[0]:
            sv = torch.sum(xT[:, ctx["masters"]] * ctx["weights"], dim=-1)
            xT = torch.cat([xT, sv], dim=1)
        return xT[:, ctx["lmap"]]

    def _p_apply_np(self, xT):
        sp = self.space
        C = xT.shape[0]
        xL = np.zeros((C, self.nn))
        xL[:, sp["true_ids"]] = xT
        if sp["slave_ids"].size:
            sv = np.einsum("csw,sw->cs", xT[:, sp["masters"]],
                           sp["weights"])
            xL[:, sp["slave_ids"]] = sv
        return xL

    def _pT_apply(self, yL):
        """full nodes (C, nn) -> true (C, nt), by gathers: where the JAX
        package scatter-adds the slave rows onto their masters, each true
        dof sums its own (slave, weight) pairs in a fixed order."""
        ctx = self.ctx
        yT = yL[:, ctx["true_ids"]]
        if ctx["pt_idx"].shape[1]:
            yz = torch.cat([yL, torch.zeros_like(yL[:, :1])], dim=1)
            yT = yT + torch.sum(yz[:, ctx["pt_idx"]] * ctx["pt_w"], dim=-1)
        return yT

    def _assemble(self, y_e):
        """(C, NE, nd) element vectors -> (C, nn) through the incidence
        gather (the JAX package's scatter-add `e_to_l`)."""
        return mop.e_to_l_gather(y_e, self.ctx["inc"], self.ctx["inc_mask"])

    def _elem(self, uT):
        """true (d, nt) -> element layout (NE, d, nd)."""
        return self._p_apply(uT)[:, self.ctx["gather"]].transpose(0, 1)

    def qupdate(self, S):
        """(sJit (NE, NQ, d, d), dt estimate 0-d, zone-max viscosity
        (NE,)) of state S."""
        ctx = self.ctx
        sJit, dtm, visc = amr_qupdate(
            self._elem(S["x"]), self._elem(S["v"]), S["e"],
            ctx["rho0DetJ0w"], ctx["Jac0inv"], self.tables, self._h0,
            ctx["depths"], dim=self.dim, h1order=self.h1order,
            cfl=self.opt.cfl, gamma=1.4)
        if self.comm is not None:
            dtm = self.comm.allreduce_min(dtm)
        return sJit, dtm, visc

    def mass_apply(self, uT):
        """The constrained H1 mass on true dofs (d, nt), essential rows
        zeroed: P^T A P, with A the element matrices.  (The JAX package
        applies the sum-factorized form; on the card six thin GEMMs of
        that form cost ~30 us each at NE 2,745 where one batched product
        of the element matrices costs a fraction: the two agree to
        round-off.)"""
        ctx = self.ctx
        ue = self._p_apply(uT)[:, ctx["gather"]]              # (d, NE, nd)
        ye = torch.einsum("eij,cej->cei", ctx["Mv"], ue)
        yT = self._ranks_sum(self._pT_apply(self._assemble(ye)))
        return torch.where(ctx["ess_true"], torch.zeros_like(yT), yT)

    def _solve_velocity(self, sJit):
        d = self.dim
        ctx = self.ctx
        one_l2 = torch.ones((sJit.shape[0], self.ld), dtype=self.dtype,
                            device=self.device)
        Fone = fop.force_mult(one_l2, sJit, self.tables, dim=d,
                              ftz_eps2=self.ftz_eps2)
        rhs = -self._ranks_sum(
            self._pT_apply(self._assemble(Fone.transpose(0, 1))))
        rhs = torch.where(ctx["ess_true"], torch.zeros_like(rhs), rhs)

        def apply_flat(u):
            return self.mass_apply(u.reshape(d, -1)).reshape(1, -1)

        # plain (unpreconditioned) CG: the AMR variant's FA velocity
        # solve is CGSolver with no preconditioner
        # (amr/laghos_solver.cpp:286-296).  On the card its iterations
        # replay a CUDA graph: the graded meshes' masses are ill-conditioned
        # enough that most solves run into cg_max_iter, ~60 small kernels
        # an iteration.  Over several ranks it runs eagerly: its one
        # collective, the all-reduce in mass_apply, cannot sit inside a
        # graph; the dots run on vectors equal on every rank, so every rank
        # stops alike
        res = cg(apply_flat, rhs.reshape(1, -1), self.opt.cg_tol,
                 self.opt.cg_max_iter, reads=self._cg_reads,
                 graph=self._one_rank())
        it = torch.sum(res.iters)
        self.h1_iters = self.h1_iters + it
        self.h1_solves += 1
        return res.x.reshape(d, -1), it

    def _solve_energy(self, sJit, vT):
        e_rhs = fop.force_mult_transpose(self._elem(vT), sJit, self.tables,
                                         dim=self.dim)
        return torch.einsum("eij,ej->ei", self.ctx["Me_inv"], e_rhs)

    def _mult(self, S):
        sJit, dtmin, visc_max = self.qupdate(S)
        dv, h1it = self._solve_velocity(sJit)
        de = self._solve_energy(sJit, S["v"])
        return {"x": S["v"], "v": dv, "e": de}, dtmin, h1it

    def advance(self, S, dt, count_stage1=False):
        """RK step (ode_solver 1/2/3/4/6, amr/laghos.cpp:337-354) + dt
        estimate + per-zone max viscosity estimator.  Returns (S_new,
        dt_est 0-d, zone-max viscosity (NE,), CG iterations 0-d), all on
        the device.

        count_stage1: the reference's stage-1 qupdate is memoized from
        the previous post-step GetTimeStepEstimate, so its dt estimate
        contributes ONLY when the quad data was invalidated — after a
        rejected step (ResetQuadratureData) or a mesh change (AMRUpdate
        sets quad_data_is_current = false).  Mirrors the main driver's
        count_stage1 handling (laghos.cpp / laghos_solver.cpp:1028)."""
        dt = float(dt)
        acc = {"dt": torch.full((), float("inf"), dtype=self.dtype,
                                device=self.device),
               "it": torch.zeros((), dtype=torch.long, device=self.device)}

        def ax(a, c, b):
            return {k: a[k] + c * b[k] for k in a}

        def comb(fn, *states):
            return {k: fn(*(s[k] for s in states)) for k in states[0]}

        def mult(y, counted=True):
            k, dtm, it = self._mult(y)
            if counted:
                acc["dt"] = torch.minimum(acc["dt"], dtm)
            acc["it"] = acc["it"] + it
            return k

        s = int(self.opt.ode_solver)
        if s == 1:
            S_new = ax(S, dt, mult(S, count_stage1))
        elif s == 2:
            # mfem RK2Solver(0.5) — midpoint
            k1 = mult(S, count_stage1)
            k2 = mult(ax(S, dt / 2, k1))
            S_new = ax(S, dt, k2)
        elif s == 3:
            # RK3 SSP
            k1 = mult(S, count_stage1)
            y = ax(S, dt, k1)
            k2 = mult(y)
            y = comb(lambda s0, yy, kk: 0.75 * s0 + 0.25 * (yy + dt * kk),
                     S, y, k2)
            k3 = mult(y)
            S_new = comb(
                lambda s0, yy, kk: (s0 + 2.0 * (yy + dt * kk)) / 3.0,
                S, y, k3)
        elif s == 4:
            k1 = mult(S, count_stage1)
            k2 = mult(ax(S, dt / 2, k1))
            k3 = mult(ax(S, dt / 2, k2))
            k4 = mult(ax(S, dt, k3))
            S_new = comb(
                lambda s0, a1, a2, a3, a4:
                s0 + dt / 6.0 * (a1 + 2 * a2 + 2 * a3 + a4),
                S, k1, k2, k3, k4)
        elif s == 6:
            from ..hydro import _RK6_A, _RK6_B
            ks = []
            for i in range(8):
                y = S
                for j in range(i):
                    if _RK6_A[i][j] != 0.0:
                        y = ax(y, dt * _RK6_A[i][j], ks[j])
                ks.append(mult(y, count_stage1 if i == 0 else True))
            S_new = S
            for j in range(8):
                if _RK6_B[j] != 0.0:
                    S_new = ax(S_new, dt * _RK6_B[j], ks[j])
        else:
            raise ValueError(f"AMR: unsupported ode solver {s}")
        _, dtm_f, v_f = self.qupdate(S_new)
        dt_est = torch.minimum(acc["dt"], dtm_f)
        # the estimator is the zone-max viscosity of the LAST qupdate
        # (amr/laghos_solver.cpp:467-468 resets it per call)
        return S_new, dt_est, v_f, acc["it"]

    # ------------------------------------------------------------------
    def apply_amr(self, refine_keys=(), deref_keys=()):
        """Modify the forest and transfer (x, v, e, x0) to the new space,
        on the host.

        Returns True if the mesh changed (the reference's mesh_changed,
        amr/laghos.cpp:633-719)."""
        from .transfer import H1Transfer, L2Transfer, TransferPlan

        old_order = list(self.forest.leaf_list())
        old_gather = np.asarray(self.space["gather"])
        changed = False
        if refine_keys:
            changed |= bool(self.forest.refine(list(refine_keys)))
        if deref_keys and not changed:
            changed |= bool(self.forest.derefine(list(deref_keys)))
        if not changed:
            return False
        new_order = list(self.forest.leaf_list())
        plan = TransferPlan(old_order, new_order, self.dim)

        xT, vT, e_old = self.global_state()
        xL = self._p_apply_np(xT)
        vL = self._p_apply_np(vT)
        x0L = self._p_apply_np(np.asarray(self.x0_T))
        xe = np.stack([xL, vL, x0L], 0)[:, :, old_gather]  # (3, d, NEo, nd)
        xe = xe.reshape(3 * self.dim, len(old_order), -1)
        h1t = H1Transfer(self.opt.order_v, self.dim)
        new_evals = h1t.element_values(plan, xe)           # (3d, NEn, nd)
        l2t = L2Transfer(self.opt.order_e, self.dim)
        new_e = l2t.element_values(plan, e_old)

        # rebuild space arrays, then assemble L-vectors from element values
        self._build_space_arrays()
        sp = self.space
        flat_g = sp["gather"].reshape(-1)
        first = np.zeros(sp["nn"], dtype=np.int64)
        first[flat_g[::-1]] = np.arange(flat_g.size - 1, -1, -1)
        full = new_evals.reshape(3 * self.dim, -1)[:, first]
        d = self.dim
        xT_new = full[0:d][:, sp["true_ids"]]
        vT_new = full[d:2 * d][:, sp["true_ids"]]
        x0T_new = full[2 * d:3 * d][:, sp["true_ids"]]
        # essential velocity BCs on the new space
        vT_new[sp["ess"][:, sp["true_ids"]]] = 0.0
        self.x0_T = x0T_new
        self._rebuilt(self._build_geometry(), xT_new, vT_new, new_e)
        return True

    def compute_density(self, S):
        """rho = rho0 detJ0/detJ projected on L2 (per-zone, current mesh):
        (NE, ld) on the state's device."""
        d = self.dim
        tb = self.tables
        J = qop.jacobians(self._elem(S["x"]), tb["H1B"], tb["H1G"], d)
        D = tb["W"][None, :] * smallmat.det(J, d)
        M = mop.l2_mass_matrices(D, tb["L2B"], d)
        rt = self.ctx["rho0DetJ0w"].reshape((-1,) + (self.nq1,) * d)
        rhs = top.eval_transpose(rt, tb["L2B"].T, d).reshape(-1, self.ld)
        return torch.linalg.solve_ex(M, rhs[..., None])[0][..., 0]

    def e_norm(self):
        """|e| of the state; over ranks the sum of squares all-reduced."""
        e = self.state["e"]
        sq = torch.sum(e * e)
        if self.comm is not None:
            sq = self.comm.allreduce_sum(sq)
        return float(torch.sqrt(sq))

    # ---- GetPerElementMinMax / FindElementsWithVertex equivalents -------
    def _eval_at_gauss(self, vals_e, B):
        """Evaluate per-element tensor-nodal fields (..., NE, n1^d) at the
        Gauss points of table B — GridFunction::GetValues under
        GetPerElementMinMax (amr/laghos.cpp:826-866).  Returns (..., NE,
        npts^d)."""
        d = self.dim
        n1 = B.shape[1]
        lead = vals_e.shape[:-1]
        out = top.eval_values(vals_e.reshape(lead + (n1,) * d), B, d)
        return out.reshape(lead + (-1,))

    def v_min_max(self, S):
        """Per-element (min, max) of |v| at the int points of order
        order_v + 1 — GetPerElementMinMax(v_gf, ...) on a vector gf
        takes the pointwise Euclidean norm (amr/laghos.cpp:846-857)."""
        v_e = self._p_apply(S["v"])[:, self.ctx["gather"]]  # (d, NE, nd)
        vq = self._eval_at_gauss(v_e, self._vB)
        mag = torch.sqrt(torch.sum(vq * vq, dim=0))        # (NE, npts^d)
        return torch.amin(mag, dim=1), torch.amax(mag, dim=1)

    def rho_max(self, S):
        """Per-element max of the L2-projected density at the int points
        of order order_e + 1 (ComputeDensity + GetPerElementMinMax,
        amr/laghos.cpp:663-666)."""
        return torch.amax(self._eval_at_gauss(self.compute_density(S),
                                              self._rB), dim=1)

    def _near_vertex(self, S, position, size=1e-10):
        """(NE,) bool: elements with a corner vertex within `size` of
        `position` on the CURRENT (deformed) mesh."""
        xL = self._p_apply(S["x"])
        xc = xL[:, self.ctx["gather"][:, self._corners]]   # (d, NE, 2^d)
        pos = torch.as_tensor(np.asarray(position, np.float64)[:self.dim],
                              dtype=self.dtype, device=self.device)
        dist2 = torch.sum((xc - pos[:, None, None]) ** 2, dim=0)
        return torch.any(dist2 <= size * size, dim=1)

    def elements_with_vertex(self, S, position, size=1e-10):
        """Leaf indices, among this process's elements, with a corner
        vertex within `size` of `position` on the CURRENT (deformed) mesh —
        FindElementsWithVertex (amr/laghos.cpp:799-820), used for
        blast-zone deref protection."""
        near = self._near_vertex(S, position, size).cpu().numpy()
        return np.where(near)[0] + self.elements[0]

    def indicators(self, S, visc_max, position, size=1e-10):
        """What the AMR block reads, computed on the device and copied to
        the host in one transfer: dict of (NE,) NumPy arrays "est" (the
        zone-max viscosity), "v_min", "rho_max", "near_blast" (bool), and
        the float "e_norm" of S.  Over ranks each rank computes its chunk's
        and the chunks are all-gathered in one collective (the squares of
        |e| summed in rank order), so that every rank decides alike."""
        v_min, _ = self.v_min_max(S)
        e = S["e"]
        flat = torch.cat([visc_max, v_min, self.rho_max(S),
                          self._near_vertex(S, position, size).to(self.dtype),
                          torch.sum(e * e).reshape(1)]).double().cpu().numpy()
        parts = ([flat] if self.comm is None
                 else self._gather_chunks(flat, lambda n: (4 * n + 1,)))
        cols = np.concatenate([p[:-1].reshape(4, -1) for p in parts], axis=1)
        en = float(np.sqrt(sum(float(p[-1]) for p in parts)))
        return {"est": cols[0], "v_min": cols[1], "rho_max": cols[2],
                "near_blast": cols[3] > 0.0, "e_norm": en}


# the element-axis arrays, split over ranks; the rest (node and true-dof
# data) is whole on every rank (`laghos_tpu/parallel/sharding.py:108-109`)
ELEMENT_KEYS = ("gather", "rho0DetJ0w", "Mv", "Jac0inv", "Me_inv", "depths")


def amr_qupdate(x_e, v_e, e_b, rho0DetJ0w, Jac0inv, tables, h0, depths,
                *, dim, h1order, cfl, gamma):
    """Sedov qupdate with the AMR variant's hard viscosity switch and
    per-element depth-scaled h0; returns (sJit (NE, NQ, d, d), dt_est 0-d,
    per-zone max viscosity (NE,)).  Plain torch on any device."""
    d = dim
    NE = x_e.shape[0]
    H1B, H1G, L2B, W = (tables["H1B"], tables["H1G"], tables["L2B"],
                        tables["W"])
    nd1 = H1B.shape[1]
    nq1 = H1B.shape[0]
    NQ = nq1**d
    l1d = L2B.shape[1]

    J = qop.jacobians(x_e, H1B, H1G, d)
    detJ = smallmat.det(J, d)
    Jinv = smallmat.inv(J, d, detJ)
    et = e_b.reshape((NE,) + (l1d,) * d)
    e_q = top.eval_values(et, L2B, d).reshape(NE, NQ)
    R = rho0DetJ0w / (detJ * W[None, :])
    E = torch.clamp(e_q, min=0.0)
    P = (gamma - 1.0) * R * E
    S = torch.sqrt(gamma * (gamma - 1.0) * E)
    eye = torch.eye(d, dtype=x_e.dtype, device=x_e.device)
    stress = -P[..., None, None] * eye

    vt = v_e.reshape((NE, d) + (nd1,) * d)
    dVt = top.eval_gradient(vt, H1B, H1G, d)
    dV = torch.movedim(dVt.reshape(NE, d, NQ, d), 1, 2)
    sgrad = torch.einsum("...ab,...bk->...ak", dV, Jinv)
    sym = 0.5 * (sgrad + sgrad.transpose(-2, -1))
    mu, compr_dir = smallmat.sym_eig_smallest(sym, d)
    Jpi = torch.einsum("...ab,...bk->...ak", J, Jac0inv)
    ph_dir = torch.einsum("...ab,...b->...a", Jpi, compr_dir)
    h0_e = h0 / (2.0 ** depths.to(x_e.dtype))              # (NE,)
    h = (h0_e[:, None] * torch.linalg.vector_norm(ph_dir, dim=-1)
         / torch.linalg.vector_norm(compr_dir, dim=-1))
    visc = 2.0 * R * h * h * torch.abs(mu)
    visc = visc + torch.where(mu < 0.0, 0.5 * R * h * S,
                              torch.zeros_like(visc))      # hard switch
    stress = stress + visc[..., None, None] * sym

    sv = smallmat.min_singular_value(J, d)
    ih = 1.0 / (sv / h1order)
    idt = S * ih + 2.5 * visc * ih * ih / R
    inf = torch.full_like(idt, float("inf"))
    dtq = torch.where(idt > 0.0,
                      cfl / torch.where(idt > 0.0, idt,
                                        torch.ones_like(idt)), inf)
    dtq = torch.where(detJ < 0.0, torch.zeros_like(dtq), dtq)

    sJit = torch.einsum("...vk,...gk->...gv", stress, Jinv)
    sJit = sJit * (W[None, :] * detJ)[..., None, None]
    return sJit, torch.min(dtq), torch.amax(visc, dim=1)
