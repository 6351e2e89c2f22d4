"""LagrangianHydroOperator: the semi-discrete Euler RHS in PyTorch.

The conforming operator of the reference (laghos_solver.cpp:104-796) over a
state dict
    S = {"x": (dim, nH1), "v": (dim, nH1), "e": (NE, l2d)}
solving, per evaluation (laghos_solver.cpp:308-518):
    dx/dt = v
    Mv dv/dt = - F . 1            (Jacobi-PCG on the H1 mass)
    Me de/dt = + F^T . v (+ src)  (CG on the L2 mass, or its inverse)
with the force q-data recomputed by the q-update.

Everything static (basis tables, gather maps, t=0 mass data, lattice
tables, the assembled mass) is built once on the host, in NumPy and CPU
torch at the run's precision, then copied to the run's device (the card
unless the caller asks for the CPU).  The per-step work runs eagerly on
that device.  As in `laghos_tpu.hydro.Hydro` with dense_ops=False:

* partial assembly (PA, `p_assembly`, the default in 2D and 3D), per
  velocity component a batched CG on the matrix-free mass, CG on the L2
  mass for the energy; two operator paths:
  - the whole-lattice path (the default, `structured_el` and
    `lattice_ops`) on raster Cartesian meshes: elements sorted to raster
    order, dofs renumbered to the lattice; the q-update, F.1, F^T.v and
    the H1 mass apply run as banded contractions (ops/lattice.py) and the
    q-point physics as the lattice-layout CUDA kernel; `precond`
    "auto"/"kron" selects the Kronecker-exact mass inverse;
  - the gather path on any other mesh (or with structured_el=False,
    lattice_ops=False): gather, sum-factorized contractions, assembly
    through the incidence gather (or the parity transforms of
    ops/structured.py when only `structured_el` holds) and the
    element-layout kernel;
* full assembly (FA, `p_assembly=False`, `-fa`, and always in 1D, where
  the reference has no PA): the gather-path q-update and force, one
  coupled Jacobi-PCG over all d*ndof velocity unknowns through the
  assembled sparse H1 mass (ops/assemble.py), and the energy update
  through the inverted element L2 mass matrices.

With `ozaki` (3D, f64, PA) the hot contractions of either PA path run as
Ozaki products, f64-accurate sums of exact int8 digit products
(ops/omm.py, the split kernel `csrc/split.cu`): the banded chains of
ops/lattice_oz.py with the mixed-precision iterative-refinement velocity
solve on the lattice path, the dense element operators on the gather path,
and the L2 energy CG's mass apply on both.

No path assembles with atomics, so a run is bitwise repeatable on the
card (the FA sparse product included, as chip_smoke.py checks).

`debug_nans` (the CLI's --debug-nans) checks the outputs of every phase
(q-update, F.1, velocity solve, F^T.v, energy solve) for non-finite values
and raises FloatingPointError naming the phase and `current_step`.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from . import problems
from .device import setup
from .fem import basis as fb
from .fem import quadrature as fq
from .fem.mesh import Mesh
from .fem.space import build_h1_space
from .ops import assemble as aop
from .ops import force as fop
from .ops import lattice as lop
from .ops import lattice_oz as lzo
from .ops import mass as mop
from .ops import omm
from .ops import qupdate as qop
from .ops import smallmat
from .ops import structured
from .ops import tensor as top
from .solvers.cg import cg
from .timing import block


@dataclasses.dataclass
class Options:
    """Run configuration mirroring the reference CLI (laghos.cpp:181-278),
    the fields this port implements."""

    problem: int = 1
    order_v: int = 2          # -ok
    order_e: int = 1          # -ot
    order_q: int = -1         # -oq
    cfl: float = 0.5
    cg_tol: float = 1e-8      # -cgt
    cg_max_iter: int = 300    # -cgm
    p_assembly: bool = True   # -pa / -fa (forced off in 1D, which the
                              # reference runs without PA)
    impose_visc: bool = False  # -iv
    blast_energy: float = 1.0  # -E0
    delta_tol: float = 1e-12   # -dtol: distance within which a mesh vertex
                               # must lie of the Sedov blast position
    ode_solver: int = 4        # -s
    structured_el: bool = True  # raster element order, lattice dof
                                # numbering and parity E<->L transforms on
                                # Cartesian meshes (ops/structured.py);
                                # falls back off raster meshes
    lattice_ops: bool = True    # whole-lattice banded operators on raster
                                # meshes (ops/lattice.py); needs
                                # structured_el
    precond: str = "auto"       # velocity-mass CG preconditioner: "jacobi"
                                # (reference parity), "kron" (per-axis
                                # Kronecker inverse on the lattice), "auto"
                                # (kron where available, else jacobi)
    ozaki: bool = False         # f64 mode of the JAX package's TPU: the hot
                                # contractions (CG mass applies, force pair,
                                # q-update interpolation) as Ozaki int8
                                # products (ops/omm.py); banded chains on
                                # raster meshes (ops/lattice_oz.py).  3D f64
                                # only
    ozaki_slices: int = 8       # dynamic slices of the lattice chains: 8 =
                                # full f64 (~2^-56 truncation), 7 = ~2^-49
    ozaki_rhs_slices: int = 0   # dynamic slices of the force chains (F.1,
                                # grad v and the L2 transpose of F^T.v),
                                # whose adjointness energy conservation rides
                                # on; 0 = ozaki_slices
    cg_ir: bool = True          # (ozaki, lattice path) velocity solve by
                                # mixed-precision iterative refinement: f32
                                # inner CG sweeps, Ozaki f64 outer residuals,
                                # the f64 CG's stopping rule
    cg_ir_inner_tol: float = 1e-5  # relative tolerance of the inner sweeps
    cg_ir_inc: bool = True      # track the outer residual incrementally
                                # (r <- r - A dx) at one slice fewer after
                                # the first outer; off = every outer
                                # recomputes r = b - A x at full slices


# Sedov blast point, a constant of the reference's delta projection
# (laghos.cpp:597-616)
_BLAST_POSITION = (0.0, 0.0, 0.0)


def _l2_node_coords(mesh: Mesh, pts_per_dim: np.ndarray) -> np.ndarray:
    """Physical coords of tensor-lattice points `pts_per_dim` (n,) in [0,1]
    inside each (multi)linear element: (NE, n^dim, dim)."""
    d = mesh.dim
    corners = mesh.verts[mesh.corners_lattice()]  # (NE, 2^d, dim)
    n = pts_per_dim.size
    ncor = 2**d
    nd = n**d
    rng = np.arange(n)
    grids = np.meshgrid(*([rng] * d), indexing="ij")
    lat = np.stack([g.reshape(-1, order="F") for g in grids], axis=1)
    w = np.ones((nd, ncor))
    for dd in range(d):
        t = pts_per_dim[lat[:, dd]][:, None]
        bit = (np.arange(ncor) >> dd) & 1
        w *= np.where(bit[None, :] == 0, 1.0 - t, t)
    return np.einsum("nc,ecd->end", w, corners)


def _axpy(a, c, b):
    """a + c * b over the state dict."""
    return {k: a[k] + c * b[k] for k in a}


def _phase(name):
    """Mark an operator piece as a phase: with `debug_nans` set, its
    floating outputs (0-d ones, such as the dt estimate, aside) must be
    finite."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(self, *args, **kw):
            out = fn(self, *args, **kw)
            if self.debug_nans:
                self._check_finite(name, out)
            return out
        return inner
    return wrap


class Hydro:
    """All static data and the per-step operators of one run."""

    def __init__(self, mesh: Mesh, opt: Options, dtype=torch.float64,
                 device="cuda"):
        """Static data of one run on `device` ("cuda", the default, or
        "cpu"), resolved by device.setup: without a card "cuda" raises."""
        if mesh.dim not in (1, 2, 3):
            raise ValueError(f"mesh dimension {mesh.dim}")
        if opt.ode_solver not in (1, 2, 3, 4, 6, 7):
            raise ValueError(f"unknown ode solver {opt.ode_solver}")
        if opt.precond == "schwarz":
            raise NotImplementedError(
                "precond 'schwarz' is not ported yet (ROADMAP A8)")
        if opt.precond not in ("jacobi", "auto", "kron"):
            raise ValueError(f"unknown precond {opt.precond!r}")
        if opt.ozaki:
            if mesh.dim != 3 or dtype != torch.float64 or not opt.p_assembly:
                raise ValueError(
                    "ozaki mode covers the 3D f64 partial-assembly path")
            if not 1 <= opt.ozaki_slices <= omm.S_FULL:
                raise ValueError(f"ozaki_slices must be in [1, {omm.S_FULL}]"
                                 f", got {opt.ozaki_slices}")
            if not 0 <= opt.ozaki_rhs_slices <= opt.ozaki_slices:
                raise ValueError(
                    f"ozaki_rhs_slices must be in [0, ozaki_slices = "
                    f"{opt.ozaki_slices}], got {opt.ozaki_rhs_slices}")
        self.device = setup(device)
        if opt.structured_el:
            mesh = structured.reorder_mesh_elements_to_raster(mesh) or mesh
        self.mesh = mesh
        self.opt = opt
        self.dtype = dtype
        npdt = np.float64 if dtype == torch.float64 else np.float32
        d = self.dim = mesh.dim
        NE = self.NE = mesh.num_elems
        pb = opt.problem
        self.qupdate_calls = 0
        self.debug_nans = False
        self.current_step = 0      # the driver's step number, for messages
        # IR velocity solve counts (see ir_stats); the inner sweeps add up
        # on the device, so counting them costs no sync
        self._ir = {"solves": 0, "outers": 0, "outer_applies": 0}
        self._ir_inner = None

        self.source, self.use_visc, self.use_vort = problems.problem_flags(
            pb, d)
        if opt.impose_visc:
            self.use_visc = True
        # 1D has no PA in the reference (laghos.cpp:455-462)
        self.p_assembly = opt.p_assembly and d > 1

        # --- spaces and tables -------------------------------------------
        self.h1 = build_h1_space(mesh, opt.order_v)
        ir_order = fq.default_rule_order(opt.order_v, opt.order_e,
                                         opt.order_q)
        nq1 = self.nq1 = fq.points_for_order(ir_order)
        self.NQ = nq1**d
        _, w1 = fq.gauss_legendre(nq1)
        W = w1
        for _ in range(d - 1):
            W = np.kron(w1, W)  # x fastest on the flat q index
        h1b = fb.h1_gl_basis(opt.order_v, nq1)
        l2b = fb.l2_bernstein_basis(opt.order_e, nq1)
        # host copies in the run's precision (setup arithmetic), device
        # copies for the step
        host = {"H1B": h1b.B, "H1G": h1b.G, "L2B": l2b.B, "W": W}
        self._tables_cpu = {k: torch.tensor(v, dtype=dtype)
                            for k, v in host.items()}
        self.tables = {k: self._dev(v) for k, v in self._tables_cpu.items()}
        self.tables["Winv"] = 1.0 / self.tables["W"]
        self.oz = None
        if opt.ozaki:
            # dense element operators split once (8 slices, as the JAX
            # package): the gather path's products and the L2 energy CG
            h1bd, h1gd = top.dense_ops(h1b.B, h1b.G, d)
            l2bd, _ = top.dense_ops(l2b.B, np.zeros_like(l2b.B), d)
            gcat = np.concatenate(list(h1gd), axis=0)       # (3NQ, nd)

            def sp(B):
                return omm.split_static(B, device=self.device)

            self.oz = {
                "h1": (sp(h1bd.T), sp(h1bd)),
                "l2": (sp(l2bd.T), sp(l2bd)),
                "force": (sp(l2bd.T), sp(gcat)),
                "forceT": (sp(gcat.T), sp(l2bd)),
                "qup": (sp(gcat.T), sp(l2bd.T)),
            }
        self._sm = (structured.detect_structure(mesh, self.h1.gather,
                                                opt.order_v)
                    if opt.structured_el else None)
        if self._sm is not None:
            # relabel dofs to the raster lattice: the struct transforms'
            # permutation becomes the identity and the L-vector is the
            # dense dof lattice
            self._sm = structured.renumber_space_to_raster(self.h1,
                                                           self._sm)
        self.gather = torch.as_tensor(self.h1.gather, dtype=torch.long,
                                      device=self.device)
        self.ndof = self.h1.ndof
        self._inc = self._incmask = None
        if self._sm is None:
            inc, msk = mop.build_incidence(self.h1.gather, self.ndof)
            self._inc = torch.as_tensor(inc, dtype=torch.long,
                                        device=self.device)
            self._incmask = self._dev(torch.tensor(msk, dtype=dtype))
        self.nd1 = opt.order_v + 1
        self.l1d = opt.order_e + 1
        self.ld = self.l1d**d

        # --- initial state ------------------------------------------------
        x0 = self.h1.node_coords                       # (ndof, d)
        v0 = problems.v0(pb, x0, d)                    # (ndof, d)
        self.ess_mask = np.stack(
            [self.h1.ess_mask(c) for c in range(d)])   # (d, ndof)
        v0 = v0.copy()
        v0.T[self.ess_mask] = 0.0

        # --- t=0 geometry ------------------------------------------------
        x0_l = x0.T                                    # (d, ndof)
        x0_e = x0_l[:, self.h1.gather].transpose(1, 0, 2)  # (NE,d,nd)
        J0 = qop.jacobians(torch.tensor(x0_e, dtype=dtype),
                           self._tables_cpu["H1B"], self._tables_cpu["H1G"],
                           d).numpy()
        detJ0 = np.linalg.det(J0)                      # (NE, NQ)
        self.Jac0inv = np.linalg.inv(J0)               # (NE, NQ, d, d)

        # L2 fields: interpolate at Gauss-Legendre nodal points, convert to
        # Bernstein (laghos.cpp:589-624)
        gl_nodes, _ = fq.gauss_legendre(opt.order_e + 1)
        l2_nodes = _l2_node_coords(mesh, gl_nodes)     # (NE, ld, d)
        rho0_nodal = problems.rho0(pb, l2_nodes, d)    # (NE, ld)
        T1 = fb.nodal_to_bernstein(opt.order_e)
        rho0_b = self._nodal_to_bernstein_nd(rho0_nodal, T1)
        if pb == 1:
            e_nodal = self._sedov_delta_nodal(gl_nodes, detJ0)
        else:
            e_nodal = problems.e0(pb, l2_nodes, d)
        e_b = self._nodal_to_bernstein_nd(e_nodal, T1)

        centers = _l2_node_coords(mesh, np.array([0.5]))[:, 0, :]
        gamma_e = problems.gamma(pb, centers, d)       # (NE,)
        # rho0 at qpoints from the *projected* gf (laghos_solver.cpp:1186)
        L2Bq = l2b.B.astype(npdt)
        rho0_q = self._l2_eval_np(rho0_b, L2Bq)        # (NE, NQ)
        self.rho0DetJ0w = W[None, :] * rho0_q * detJ0

        vol = float((W[None, :] * detJ0).sum())
        if d == 1:
            h0 = vol / NE
        elif d == 2:
            h0 = np.sqrt(vol / NE)
        else:
            h0 = (vol / NE) ** (1.0 / 3.0)
        self.h0 = h0 / opt.order_v                     # laghos_solver.cpp:262

        # --- mass data (pointwise rho0 coefficient, laghos_solver.cpp:178) -
        xq0 = self._h1_eval_np(x0_e, h1b.B.astype(npdt))
        rho0_pw = problems.rho0(pb, xq0, d)            # (NE, NQ)
        massD_cpu = torch.tensor(W[None, :] * rho0_pw * detJ0, dtype=dtype)
        self.massD = self._dev(massD_cpu)
        diag = mop.h1_mass_diag(self.h1.gather, self.ndof, massD_cpu,
                                self._tables_cpu["H1B"], d)
        self.h1_dinv = self._dev(1.0 / diag)

        # RT gravity RHS is constant in time: B_g = Mv . g, g = (0,-1,0)
        self.rt_rhs = None
        if self.source == 2:
            g = np.zeros((d, self.ndof))
            g[1, :] = -1.0
            self.rt_rhs = self._dev(mop.h1_mass_apply(
                torch.tensor(g, dtype=dtype),
                torch.as_tensor(self.h1.gather, dtype=torch.long),
                self.ndof, massD_cpu, self._tables_cpu["H1B"], d))

        self.ess_mask_t = torch.as_tensor(self.ess_mask, device=self.device)
        self.gamma_t = self._dev(torch.tensor(gamma_e, dtype=dtype))
        self.rho0DetJ0w_t = self._dev(torch.tensor(self.rho0DetJ0w,
                                                   dtype=dtype))
        # whole-lattice operators (raster meshes only); in Ozaki mode their
        # int8 splits and the f32 shadow of the mass operator for the inner
        # sweeps of the IR velocity solve
        self._lat = self._lat_dims = self._edims = None
        self._lat_oz = self._lat32 = None
        if opt.lattice_ops and self.p_assembly:
            built = lop.build_lattice_ops(
                self, lambda t: self._dev(t.to(dtype)))
            if built is not None:
                self._lat_dims = built.pop("lat_dims")
                self._lat = built
                self._edims = self._sm.dims
                if opt.ozaki:
                    self._lat_oz = lzo.build_lattice_oz(
                        h1b.B, h1b.G, l2bd, tuple(reversed(self._sm.dims)),
                        n_slices=opt.ozaki_slices, device=self.device)
                    self._lat32 = {
                        "Ts": tuple(T.float() for T in built["Ts"]),
                        "Dq": built["Dq"].float()}
                    if "kron" in built:
                        self._lat32["kron"] = tuple(
                            Mk.float() for Mk in built["kron"])
        Jac0inv_t = torch.tensor(self.Jac0inv, dtype=dtype)
        if self._lat is not None:
            self.Jac0inv_t = None      # the lattice holds its own stack
        elif d == 3:
            # (9, NE, NQ) component stack for the 3D q-update kernel
            self.Jac0inv_t = self._dev(
                Jac0inv_t.reshape(NE, self.NQ, 9).permute(2, 0, 1)
                .contiguous())
        else:
            self.Jac0inv_t = self._dev(Jac0inv_t)
        self.one_l2 = torch.ones((NE, self.ld), dtype=dtype,
                                 device=self.device)
        # full assembly: the velocity mass assembled once into a global
        # sparse matrix from the time-constant rho0*detJ0 data (the
        # reference's one-time mass assembly, laghos_solver.cpp:201-221),
        # the Jacobi diagonal over all d*ndof unknowns with ones at the
        # essential dofs, and the inverted element L2 mass matrices
        self._h1_csr = self.Me_inv = self._fa_dinv = None
        self.fa_setup_seconds = 0.0
        if not self.p_assembly:
            t_fa = time.perf_counter()
            Mel = aop.h1_mass_element_matrices(
                massD_cpu, self._tables_cpu["H1B"], d)
            self._h1_csr = aop.to_csr(Mel.numpy(), self.h1.gather,
                                      self.ndof, self.device)
            Me = mop.l2_mass_matrices(massD_cpu, self._tables_cpu["L2B"], d)
            self.Me_inv = self._dev(torch.tensor(np.linalg.inv(Me.numpy()),
                                                 dtype=dtype))
            dinv = self.h1_dinv[None, :].expand(d, -1)
            self._fa_dinv = torch.where(self.ess_mask_t,
                                        torch.ones_like(dinv),
                                        dinv).reshape(1, -1)
            self.fa_setup_seconds = time.perf_counter() - t_fa
        eps = np.finfo(np.float64).eps
        self.ftz_eps2 = eps * eps

        self.S0 = {
            "x": self._dev(torch.tensor(x0_l, dtype=dtype)),
            "v": self._dev(torch.tensor(v0.T, dtype=dtype)),
            "e": self._dev(torch.tensor(e_b, dtype=dtype)),
        }

    def _dev(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device).contiguous()

    # -------------------------------------------------- setup helpers ----
    def _nodal_to_bernstein_nd(self, f_nodal: np.ndarray, T1: np.ndarray):
        d = self.dim
        n = self.l1d
        out = f_nodal.reshape((self.NE,) + (n,) * d)
        for k in range(d):
            ax = out.ndim - 1 - k
            out = np.moveaxis(
                np.tensordot(out, T1, axes=[[ax], [1]]), -1, ax)
        return out.reshape(self.NE, self.ld)

    def _l2_eval_np(self, u, B):
        d = self.dim
        ut = u.reshape((self.NE,) + (self.l1d,) * d)
        for k in range(d):
            ax = ut.ndim - 1 - k
            ut = np.moveaxis(np.tensordot(ut, B, axes=[[ax], [1]]), -1, ax)
        return ut.reshape(self.NE, -1)

    def _h1_eval_np(self, x_e, B):
        """positions at qpoints: (NE, NQ, dim)."""
        d = self.dim
        ut = x_e.reshape((self.NE, d) + (self.nd1,) * d)
        for k in range(d):
            ax = ut.ndim - 1 - k
            ut = np.moveaxis(np.tensordot(ut, B, axes=[[ax], [1]]), -1, ax)
        return np.moveaxis(ut.reshape(self.NE, d, -1), 1, 2)

    def _sedov_delta_nodal(self, gl_nodes: np.ndarray,
                           detJ0: np.ndarray) -> np.ndarray:
        """Point-blast energy: MFEM's delta projection + global rescale.

        Replicates GridFunction::ProjectDeltaCoefficient as invoked at
        laghos.cpp:597-616: find the mesh vertex nearest the blast point,
        set dofs of adjacent elements to the ProjectDelta polynomial
        ((1-t)^p or t^p per axis), then scale so the global integral is
        blast_energy / 2^dim.
        """
        mesh, opt, d = self.mesh, self.opt, self.dim
        center = np.asarray(_BLAST_POSITION[:d])
        dist = np.linalg.norm(mesh.verts - center[None, :], axis=1)
        v_idx = int(np.argmin(dist))
        out = np.zeros((self.NE, self.ld))
        if dist[v_idx] >= opt.delta_tol:
            raise RuntimeError("Delta function could not be initialized "
                               "(no mesh vertex at the blast position)")
        p = opt.order_e
        # nodal L2 basis (Lagrange at GL points) at the quadrature points,
        # for the element mass matrices of the integral normalization
        qpts, w1 = fq.gauss_legendre(self.nq1)
        Bn, _ = fb.lagrange_tables(gl_nodes, qpts)
        full = Bn
        for _ in range(d - 1):
            full = np.kron(Bn, full)
        W = w1
        for _ in range(d - 1):
            W = np.kron(w1, W)

        lat = np.stack(
            [g.reshape(-1, order="F") for g in np.meshgrid(
                *([np.arange(p + 1)] * d), indexing="ij")], axis=1)

        corners = mesh.corners_lattice()
        integral = 0.0
        for e in range(self.NE):
            hit = np.where(corners[e] == v_idx)[0]
            if hit.size == 0:
                continue
            # ProjectDelta polynomial for the local corner: per axis
            # (1-t)^p or t^p depending on the corner bit (MFEM
            # L2_*Element::ProjectDelta with Poly_1D::CalcDelta = t^p)
            corner_bits = [(int(hit[0]) >> dd) & 1 for dd in range(d)]
            vals1 = np.empty((d, p + 1))
            for dd in range(d):
                vals1[dd] = (gl_nodes**p if corner_bits[dd] == 1
                             else (1.0 - gl_nodes) ** p)
            vals = np.ones(self.ld)
            for n_loc in range(self.ld):
                for dd in range(d):
                    vals[n_loc] *= vals1[dd][lat[n_loc, dd]]
            out[e] = vals
            # element mass (nodal basis, no coefficient, initial mesh)
            Dq = W * detJ0[e]
            Me = np.einsum("qi,qj,q->ij", full, full, Dq)
            integral += (Me @ vals).sum()
        scale = (opt.blast_energy / 2**d) / integral
        out *= scale
        return out

    def _check_finite(self, phase, out):
        """--debug-nans: raise if a floating output of `phase` (tensors of
        one dimension or more, in `out` or its tuples) is not finite."""
        todo = [out]
        while todo:
            x = todo.pop()
            if isinstance(x, (tuple, list)):
                todo.extend(x)
            elif (isinstance(x, torch.Tensor) and x.is_floating_point()
                  and x.dim() > 0 and not bool(torch.isfinite(x).all())):
                raise FloatingPointError(
                    f"--debug-nans: non-finite values after the {phase} at "
                    f"step {self.current_step}")

    # -------------------------------------------------- operator pieces --
    @_phase("q-update")
    def _qupdate(self, S):
        """(sJit, dt_min) at state S.  sJit is (9, NE, NQ) in 3D and
        (NE, NQ, 2, 2) in 2D on the gather path; (9, Qz, Qy, Qx) and
        (4, Qy, Qx) q-lattice stacks on the lattice path."""
        self.qupdate_calls += 1
        d = self.dim
        if self._lat is not None:
            qup = (lop.qupdate3d_lattice if d == 3
                   else lop.qupdate2d_lattice)
            kw = {} if d == 2 else {"oz": self._lat_oz}
            return qup(S["x"], S["v"], S["e"], self._lat, self._lat_dims,
                       self._edims, self.tables,
                       h1order=float(self.opt.order_v), cfl=self.opt.cfl,
                       use_viscosity=self.use_visc,
                       use_vorticity=self.use_vort, **kw)
        x_e = self._gather_e(S["x"])
        v_e = self._gather_e(S["v"])
        if d == 3:
            return qop.qupdate3d(
                x_e, v_e, S["e"], self.gamma_t, self.rho0DetJ0w_t,
                self.Jac0inv_t, self.tables, self.h0,
                h1order=float(self.opt.order_v), cfl=self.opt.cfl,
                use_viscosity=self.use_visc, use_vorticity=self.use_vort,
                oz=None if self.oz is None else self.oz["qup"])
        return qop.qupdate(
            x_e, v_e, S["e"], self.gamma_t, self.rho0DetJ0w_t,
            self.Jac0inv_t, self.tables, self.h0,
            dim=d, h1order=float(self.opt.order_v), cfl=self.opt.cfl,
            use_viscosity=self.use_visc, use_vorticity=self.use_vort)

    def _assemble(self, u_e):
        """(..., NE, nd) E-vector assembly to the L-vector."""
        if self._sm is not None:
            return structured.e_to_l_struct(u_e, self._sm)
        return mop.e_to_l_gather(u_e, self._inc, self._incmask)

    def _l_to_e(self, u):
        """(C, ndof) L-vector -> (C, NE, nd) E-vector."""
        if self._sm is not None:
            return structured.l_to_e_struct(u, self._sm)
        return mop.l_to_e(u, self.gather)

    def _gather_e(self, u):
        """(C, ndof) L-vector -> (NE, C, nd) E-vector."""
        return self._l_to_e(u).transpose(0, 1)

    @_phase("force F.1")
    def _force_rhs_raw(self, sJit):
        """F . 1 assembled to the H1 L-vector (the sw_force-timed part of
        SolveVelocity, laghos_solver.cpp:354)."""
        if self._lat_oz is not None:
            y = lzo.force_one_lattice_oz(
                sJit, self._lat_oz,
                n_slices=self.opt.ozaki_rhs_slices or None)
            return fop._flush(y.reshape(self.dim, -1), self.ftz_eps2)
        if self._lat is not None:
            # reverse banded chains assemble the L-vector directly (the
            # L2 "ones" evaluate to 1)
            f1 = (lop.force_one_lattice if self.dim == 3
                  else lop.force_one_lattice_2d)
            y = f1(sJit, self._lat["Ts"], self._lat["Tg"])
            return fop._flush(y.reshape(self.dim, -1), self.ftz_eps2)
        if self.oz is not None:
            Fone = fop.force_mult9_oz(self.one_l2, sJit, self.oz["force"],
                                      ftz_eps2=self.ftz_eps2)
        elif self.dim == 3:
            Fone = fop.force_mult9(self.one_l2, sJit, self.tables,
                                   ftz_eps2=self.ftz_eps2)
        else:
            Fone = fop.force_mult(self.one_l2, sJit, self.tables,
                                  dim=self.dim, ftz_eps2=self.ftz_eps2)
        return self._assemble(Fone.transpose(0, 1))

    def _prep_velocity_rhs(self, raw):
        """rhs.Neg(), RT gravity source, essential-dof elimination."""
        rhs = -raw
        if self.rt_rhs is not None:
            rhs = rhs + self.rt_rhs
        return torch.where(self.ess_mask_t, torch.zeros_like(rhs), rhs)

    def _h1_apply_bc(self, u):
        if self._lat_oz is not None:
            y = lzo.mass_apply_lattice_oz(u, self._lat_oz, self._lat["Dq"],
                                          self._lat_dims)
        elif self._lat is not None:
            y = lop.mass_apply_lattice(u, self._lat["Ts"], self._lat["Dq"],
                                       self._lat_dims)
        else:
            ue = mop.mass_apply_e(self._l_to_e(u), self.massD,
                                  self.tables["H1B"], self.dim,
                                  oz=None if self.oz is None
                                  else self.oz["h1"])
            y = self._assemble(ue)
        return torch.where(self.ess_mask_t, torch.zeros_like(y), y)

    def _precond_velocity(self, r):
        if self._lat is not None and "kron" in self._lat:
            return lop.kron_precond_apply(r, self._lat["kron"],
                                          self._lat_dims)
        return r * self.h1_dinv[None, :]

    def _cg_velocity_ir(self, rhs):
        """Mixed-precision iterative-refinement velocity mass solve (Ozaki
        lattice mode, `laghos_tpu.hydro.Hydro._cg_velocity_ir`): inner CG
        sweeps in f32 on the f32 shadow of the banded operator, outer
        residuals through the f64-accurate Ozaki apply.  Stops on the f64
        CG's criterion (the Jacobi-weighted residual dot against its
        initial value, laghos_solver.cpp:264-284), each component on its
        own; at most 8 outers, one host sync per outer.

        The inner sweeps run in full f32 (device.setup pins no TF32); the
        JAX package's bf16 inner matmuls (cg_ir_inner_mxu) are a TPU knob,
        so the card's inner counts are not the TPU's.  Returned iteration
        count = inner sweeps + one per outer, per component, as in the JAX
        package (FOM1 counts it)."""
        ess = self.ess_mask_t
        dinv = self.h1_dinv[None, :]
        Ts32, Dq32 = self._lat32["Ts"], self._lat32["Dq"]
        tol = self.opt.cg_tol

        def apply32(u):
            y = lop.mass_apply_lattice(u, Ts32, Dq32, self._lat_dims)
            return torch.where(ess, torch.zeros_like(y), y)

        # residual slices: the truncation 2^-7S sits about a decade below
        # cg_tol; the incremental update runs at ONE slice fewer (two fewer
        # degrade RK2Avg drift from 2e-13 to 1e-11, hydro.py:810-828 of the
        # JAX package)
        s_res = min(8, max(4, int(np.ceil((-np.log2(tol) + 3.4) / 7.0))))
        s_lo = max(3, s_res - 1)

        def apply_res(u, n_slices):
            y = lzo.mass_apply_lattice_oz(u, self._lat_oz, self._lat["Dq"],
                                          self._lat_dims, n_slices=n_slices)
            return torch.where(ess, torch.zeros_like(y), y)

        def rdot(r):
            return torch.sum(r * r * dinv, dim=-1)

        if "kron" in self._lat32:
            kron32 = self._lat32["kron"]

            def prec32(rr):
                return lop.kron_precond_apply(rr, kron32, self._lat_dims)
        else:
            dinv32 = dinv.float()

            def prec32(rr):
                return rr * dinv32

        x = torch.zeros_like(rhs)
        r = rhs
        target = rdot(rhs) * (tol * tol)
        inner_max = min(self.opt.cg_max_iter, 100)
        active = rdot(r) > target
        it = torch.zeros(rhs.shape[0], dtype=torch.int64, device=rhs.device)
        outers = 0
        self._ir["solves"] += 1
        while outers < 8:
            n_active = int(active.sum())
            if n_active == 0:
                break
            res = cg(apply32, r.float(), self.opt.cg_ir_inner_tol,
                     inner_max, precond=prec32)
            dx = torch.where(active[:, None], res.x.double(),
                             torch.zeros_like(x))
            x = x + dx
            if self.opt.cg_ir_inc:
                r = r - apply_res(dx, s_res if outers == 0 else s_lo)
            else:
                r = rhs - apply_res(x, s_res)
            inner = torch.where(active, res.iters, torch.zeros_like(res.iters))
            it = it + inner + active.to(inner.dtype)
            self._ir_inner = (inner.sum() if self._ir_inner is None
                              else self._ir_inner + inner.sum())
            active = active & (rdot(r) > target)
            outers += 1
            self._ir["outers"] += 1
            self._ir["outer_applies"] += n_active
        return x, torch.sum(it)

    def ir_stats(self) -> dict:
        """Counts of the IR velocity solves so far: solves, outer
        iterations, outer_applies (one per active component and outer: the
        Ozaki residual applies) and inner_sweeps (the f32 CG iterations);
        the CG-H1 count of these solves is inner_sweeps + outer_applies."""
        inner = 0 if self._ir_inner is None else int(self._ir_inner)
        return dict(self._ir, inner_sweeps=inner)

    @_phase("velocity solve")
    def _cg_velocity(self, rhs):
        if not self.p_assembly:
            return self._cg_velocity_fa(rhs)
        if self._lat32 is not None and self.opt.cg_ir:
            return self._cg_velocity_ir(rhs)
        res = cg(self._h1_apply_bc, rhs, self.opt.cg_tol,
                 self.opt.cg_max_iter, precond=self._precond_velocity)
        return res.x, torch.sum(res.iters)

    def _cg_velocity_fa(self, rhs):
        """FA velocity solve: ONE coupled Jacobi-PCG over all d*ndof
        unknowns (laghos_solver.cpp:400-439), through the assembled sparse
        mass, so one residual and one iteration count cover every
        component."""
        d = self.dim

        def apply_flat(u):
            y = aop.csr_apply(self._h1_csr, u.reshape(d, -1))
            return torch.where(self.ess_mask_t, torch.zeros_like(y),
                               y).reshape(1, -1)

        res = cg(apply_flat, rhs.reshape(1, -1), self.opt.cg_tol,
                 self.opt.cg_max_iter, precond=lambda r: r * self._fa_dinv)
        return res.x.reshape(d, -1), torch.sum(res.iters)

    def _solve_velocity(self, sJit):
        return self._cg_velocity(self._prep_velocity_rhs(
            self._force_rhs_raw(sJit)))

    def _taylor_source(self, S):
        """Taylor-Green forcing on the current mesh
        (laghos_solver.cpp:455-465, laghos_solver.hpp:207-218)."""
        d = self.dim
        x_e = self._gather_e(S["x"])
        J = qop.jacobians(x_e, self.tables["H1B"], self.tables["H1G"], d)
        detJ = smallmat.det(J, d)
        xt = x_e.reshape((self.NE, d) + (self.nd1,) * d)
        xq = top.eval_values(xt, self.tables["H1B"], d).reshape(
            self.NE, d, self.NQ)
        X, Y = xq[:, 0], xq[:, 1]
        pi = np.pi
        fq_ = (3.0 / 8.0) * pi * (torch.cos(3 * pi * X) * torch.cos(pi * Y)
                                  - torch.cos(pi * X) * torch.cos(3 * pi * Y))
        integrand = self.tables["W"][None, :] * detJ * fq_
        it = integrand.reshape((self.NE,) + (self.nq1,) * d)
        out = top.eval_transpose(it, self.tables["L2B"].T, d)
        return out.reshape(self.NE, self.ld)

    @_phase("force F^T.v")
    def _force_transpose(self, sJit, v):
        if self._lat is not None:
            fT = (lop.force_transpose_lattice if self.dim == 3
                  else lop.force_transpose_lattice_2d)
            kw = {} if self.dim == 2 else dict(
                oz=self._lat_oz, oz_slices=self.opt.ozaki_rhs_slices or None)
            return fT(v, sJit, self._lat, self._lat_dims, self._edims,
                      self.tables, **kw)
        v_e = self._gather_e(v)
        if self.oz is not None:
            return fop.force_mult_transpose9_oz(v_e, sJit,
                                                self.oz["forceT"])
        if self.dim == 3:
            return fop.force_mult_transpose9(v_e, sJit, self.tables)
        return fop.force_mult_transpose(v_e, sJit, self.tables, dim=self.dim)

    @_phase("energy solve")
    def _cg_energy(self, e_rhs):
        if not self.p_assembly:
            # FA: the inverted element mass matrices; the iteration count
            # the JAX package reports is NE
            de = torch.einsum("eij,ej->ei", self.Me_inv, e_rhs)
            return de, torch.tensor(self.NE, device=self.device)

        def apply_A(u):
            ue = u.reshape(self.NE, self.ld)
            ue = mop.mass_apply_e(ue, self.massD, self.tables["L2B"],
                                  self.dim, oz=None if self.oz is None
                                  else self.oz["l2"])
            return ue.reshape(1, -1)

        res = cg(apply_A, e_rhs.reshape(1, -1), self.opt.cg_tol,
                 self.opt.cg_max_iter)
        iters = torch.clamp(res.iters[0], min=1)
        return res.x.reshape(self.NE, self.ld), iters

    def _solve_energy(self, S, sJit, v):
        e_rhs = self._force_transpose(sJit, v)
        if self.source == 1:
            e_rhs = e_rhs + self._taylor_source(S)
        return self._cg_energy(e_rhs)

    def _inf(self):
        return torch.tensor(float("inf"), dtype=self.dtype,
                            device=self.device)

    def _mult(self, S, sJit=None):
        """dS/dt (laghos_solver.cpp:308-327). Returns (dS, dtmin, stats).

        A provided `sJit` is reused instead of recomputed: the reference's
        q-data memoization (laghos_solver.cpp:807-814), where stage 1 of
        every accepted step reuses the q-data of the previous dt estimate.
        """
        if sJit is None:
            sJit, dtmin = self._qupdate(S)
        else:
            dtmin = self._inf()
        dv, h1it = self._solve_velocity(sJit)
        de, l2it = self._solve_energy(S, sJit, S["v"])
        return {"x": S["v"], "v": dv, "e": de}, dtmin, (h1it, l2it)

    def _mult_timed(self, S, tim, sJit=None):
        """Phase-timed RHS evaluation with device fences, for FOM runs
        (timing semantics of laghos_solver.cpp:349-489).  A provided sJit
        reuses the previous estimate's q-data without charging sw_qdata,
        like the reference's memoized stage 1."""
        if sJit is None:
            with tim.phase("qdata"):
                sJit, dtmin = block(self._qupdate(S))
            tim.quad_tstep += self.NE
        else:
            dtmin = self._inf()
        with tim.phase("force"):
            raw = block(self._force_rhs_raw(sJit))
        B = self._prep_velocity_rhs(raw)
        with tim.phase("cgH1"):
            dv, h1it = block(self._cg_velocity(B))
        tim.H1iter += int(h1it)
        with tim.phase("force"):
            e_rhs = block(self._force_transpose(sJit, S["v"]))
        if self.source == 1:
            e_rhs = e_rhs + self._taylor_source(S)
        with tim.phase("cgL2"):
            de, l2it = block(self._cg_energy(e_rhs))
        tim.L2iter += int(l2it)
        return {"x": S["v"], "v": dv, "e": de}, dtmin, (h1it, l2it)

    def _rk2avg_stage_timed(self, Scur, v0, dt, tim, sJit=None):
        if sJit is None:
            with tim.phase("qdata"):
                sJit, dtm = block(self._qupdate(Scur))
            tim.quad_tstep += self.NE
        else:
            dtm = self._inf()
        with tim.phase("force"):
            raw = block(self._force_rhs_raw(sJit))
        B = self._prep_velocity_rhs(raw)
        with tim.phase("cgH1"):
            dv, h1it = block(self._cg_velocity(B))
        tim.H1iter += int(h1it)
        V = v0 + 0.5 * dt * dv
        with tim.phase("force"):
            e_rhs = block(self._force_transpose(sJit, V))
        if self.source == 1:
            e_rhs = e_rhs + self._taylor_source(Scur)
        with tim.phase("cgL2"):
            de, l2it = block(self._cg_energy(e_rhs))
        tim.L2iter += int(l2it)
        return {"x": V, "v": dv, "e": de}, dtm, (h1it, l2it)

    # -------------------------------------------------- steppers ---------
    def _step(self, S, dt, count_stage1: bool, mult=None,
              rk2avg_stage=None, sJit1=None):
        """One RK step; returns (S_new, dt_min_of_counted_stages, stats).

        `mult` / `rk2avg_stage` override the stage evaluation (the timed
        variants); `sJit1` is the memoized stage-1 q-data."""
        if mult is None:
            first = [sJit1]

            def mult(Sc):
                sj, first[0] = first[0], None
                return self._mult(Sc, sj)
        dtacc = self._inf()
        h1tot = 0
        l2tot = 0

        def acc(dtmin, stats, counted):
            nonlocal dtacc, h1tot, l2tot
            if counted:
                dtacc = torch.minimum(dtacc, dtmin)
            h1tot = h1tot + stats[0]
            l2tot = l2tot + stats[1]

        s = self.opt.ode_solver
        if s == 7:
            S_new = self._rk2avg(S, dt, count_stage1, acc, rk2avg_stage,
                                 sJit1=sJit1)
        elif s == 1:
            k1, dtm, st = mult(S)
            acc(dtm, st, count_stage1)
            S_new = _axpy(S, dt, k1)
        elif s == 2:
            a = 0.5
            b = 1.0 / (2.0 * a)
            k1, dtm, st = mult(S)
            acc(dtm, st, count_stage1)
            y = _axpy(S, a * dt, k1)
            k2, dtm, st = mult(y)
            acc(dtm, st, True)
            S_new = _axpy(_axpy(S, (1.0 - b) * dt, k1), b * dt, k2)
        elif s == 3:
            k1, dtm, st = mult(S)
            acc(dtm, st, count_stage1)
            y = _axpy(S, dt, k1)
            k2, dtm, st = mult(y)
            acc(dtm, st, True)
            y = {k: 0.75 * S[k] + 0.25 * (y[k] + dt * k2[k]) for k in S}
            k3, dtm, st = mult(y)
            acc(dtm, st, True)
            S_new = {k: (S[k] + 2.0 * (y[k] + dt * k3[k])) / 3.0 for k in S}
        elif s == 4:
            k1, dtm, st = mult(S)
            acc(dtm, st, count_stage1)
            y = _axpy(S, dt / 2, k1)
            k2, dtm, st = mult(y)
            acc(dtm, st, True)
            y = _axpy(S, dt / 2, k2)
            k3, dtm, st = mult(y)
            acc(dtm, st, True)
            y = _axpy(S, dt, k3)
            k4, dtm, st = mult(y)
            acc(dtm, st, True)
            S_new = {k: S[k] + dt / 6.0 * (k1[k] + 2 * k2[k] + 2 * k3[k]
                                           + k4[k]) for k in S}
        else:  # s == 6
            S_new = self._rk6(S, dt, count_stage1, acc, mult)
        return S_new, dtacc, (h1tot, l2tot)

    def _rk2avg(self, S, dt, count_stage1, acc, stage_fn=None, sJit1=None):
        """Energy-conserving two-stage average scheme
        (laghos_solver.cpp:1447-1487)."""
        v0 = S["v"]
        first = [sJit1]

        def default_stage(Scur, sJit):
            if sJit is not None:
                dtm = self._inf()
            else:
                sJit, dtm = self._qupdate(Scur)
            dv, h1it = self._solve_velocity(sJit)
            V = v0 + 0.5 * dt * dv
            de, l2it = self._solve_energy(Scur, sJit, V)
            return {"x": V, "v": dv, "e": de}, dtm, (h1it, l2it)

        def stage(Scur, counted):
            sj, first[0] = first[0], None
            if stage_fn is None:
                dS, dtm, st = default_stage(Scur, sj)
            else:
                dS, dtm, st = stage_fn(Scur, v0, dt, sj)
            acc(dtm, st, counted)
            return dS

        dS = stage(S, count_stage1)
        Smid = {k: S[k] + 0.5 * dt * dS[k] for k in S}
        dS = stage(Smid, True)
        return {k: S[k] + dt * dS[k] for k in S}

    def _rk6(self, S, dt, count_stage1, acc, mult):
        """Verner's 8-stage 6th-order method (mfem RK6Solver tableau)."""
        ks = []
        for i in range(8):
            y = S
            for j in range(i):
                if _RK6_A[i][j] != 0.0:
                    y = _axpy(y, dt * _RK6_A[i][j], ks[j])
            k, dtm, st = mult(y)
            acc(dtm, st, count_stage1 if i == 0 else True)
            ks.append(k)
        out = S
        for j in range(8):
            if _RK6_B[j] != 0.0:
                out = _axpy(out, dt * _RK6_B[j], ks[j])
        return out

    # -------------------------------------------------- public API -------
    def advance(self, S, dt, count_stage1=False, sJit1=None):
        """One step plus the post-step dt estimate.

        Mirrors one iteration of the driver loop body (laghos.cpp:742-778):
        the returned dt_est is the min over every q-update since the last
        reset -- the counted RK stage states plus the final state.  The
        final q-update's stress data is returned for reuse as the next
        step's stage-1 q-data (laghos_solver.cpp:807-814); pass it back
        as `sJit1`.
        """
        S_new, dtacc, stats = self._step(S, dt, count_stage1, sJit1=sJit1)
        sj_new, dt_final = self._qupdate(S_new)
        dt_est = self._guard_finite(S_new, torch.minimum(dtacc, dt_final))
        return S_new, dt_est, stats, sj_new

    def advance_timed(self, S, dt, tim, count_stage1=False, sJit1=None):
        """Like `advance` but with per-phase stopwatches (FOM mode)."""
        first = [None if count_stage1 else sJit1]

        def mult(s):
            sj, first[0] = first[0], None
            return self._mult_timed(s, tim, sJit=sj)

        S_new, dtacc, stats = self._step(
            S, dt, count_stage1, mult=mult,
            rk2avg_stage=lambda s, v0, dtt, sj: self._rk2avg_stage_timed(
                s, v0, dtt, tim, sJit=sj),
            sJit1=first[0])
        with tim.phase("qdata"):
            sj_new, dt_final = block(self._qupdate(S_new))
        tim.quad_tstep += self.NE
        return S_new, torch.minimum(dtacc, dt_final), stats, sj_new

    def _guard_finite(self, S_new, dt_est):
        """Force step rejection for non-finite states.

        The reference rejects inverted/blown states through dt_est = 0
        (laghos_solver.cpp:1144-1148); NaN/Inf states (e.g. after a solver
        breakdown) must not slip past the `dt_est < dt` comparison, since
        NaN compares false."""
        ok = torch.isfinite(torch.sum(S_new["v"]) + torch.sum(S_new["e"])
                            + torch.sum(S_new["x"]))
        return torch.where(ok, dt_est, torch.zeros_like(dt_est))

    def dt_estimate_full(self, S):
        """(dt_est, sJit) -- seed for the stage-1 memoization."""
        sJit, dtmin = self._qupdate(S)
        return dtmin, sJit

    def energies(self, S):
        """(internal, kinetic) energy integrals, 0-d tensors
        (laghos_solver.cpp:640-697)."""
        d = self.dim
        et = S["e"].reshape((self.NE,) + (self.l1d,) * d)
        e_q = top.eval_values(et, self.tables["L2B"], d).reshape(
            self.NE, self.NQ)
        ie = torch.sum(self.rho0DetJ0w_t * e_q)
        v_e = self._gather_e(S["v"])
        vt = v_e.reshape((self.NE, d) + (self.nd1,) * d)
        v_q = top.eval_values(vt, self.tables["H1B"], d).reshape(
            self.NE, d, self.NQ)
        ke = 0.5 * torch.sum(self.rho0DetJ0w_t
                             * torch.sum(v_q * v_q, dim=1))
        return ie, ke

    def e_norm(self, S):
        """||e||_2 of the L2 coefficient vector (the driver's |e| print,
        laghos.cpp:794-825)."""
        return float(torch.sqrt(torch.sum(S["e"] * S["e"])))

    def compute_density(self, S):
        """The current density rho = rho0 detJ0 / detJ projected onto L2
        (laghos_solver.cpp:542-563): (NE, ld) Bernstein coefficients."""
        d = self.dim
        x_e = self._gather_e(S["x"])
        J = qop.jacobians(x_e, self.tables["H1B"], self.tables["H1G"], d)
        D = self.tables["W"][None, :] * smallmat.det(J, d)
        M = mop.l2_mass_matrices(D, self.tables["L2B"], d)
        # rhs_j = sum_q psi_j(q) rho0DetJ0w(q)
        rt = self.rho0DetJ0w_t.reshape((self.NE,) + (self.nq1,) * d)
        rhs = top.eval_transpose(rt, self.tables["L2B"].T, d).reshape(
            self.NE, self.ld)
        return torch.linalg.solve(M, rhs[..., None])[..., 0]


# Verner's 6(5) 8-stage tableau as used by mfem::RK6Solver.
_RK6_A = [
    [],
    [1.0 / 6.0],
    [4.0 / 75.0, 16.0 / 75.0],
    [5.0 / 6.0, -8.0 / 3.0, 5.0 / 2.0],
    [-165.0 / 64.0, 55.0 / 6.0, -425.0 / 64.0, 85.0 / 96.0],
    [12.0 / 5.0, -8.0, 4015.0 / 612.0, -11.0 / 36.0, 88.0 / 255.0],
    [-8263.0 / 15000.0, 124.0 / 75.0, -643.0 / 680.0, -81.0 / 250.0,
     2484.0 / 10625.0, 0.0],
    [3501.0 / 1720.0, -300.0 / 43.0, 297275.0 / 52632.0, -319.0 / 2322.0,
     24068.0 / 84065.0, 0.0, 3850.0 / 26703.0],
]
_RK6_B = [3.0 / 40.0, 0.0, 875.0 / 2244.0, 23.0 / 72.0, 264.0 / 1955.0,
          0.0, 125.0 / 11592.0, 43.0 / 616.0]
