"""One rank's block of a conforming `Hydro`: the base of the rank views.

A rank view is a `Hydro` whose arrays are one rank's block of the global
run's, on the rank's device.  Every rank builds the same global `Hydro` on
the host (the setup is deterministic) and keeps only its block.  The view
runs the inherited operators, steppers and loops (`_step`, `advance`,
`run_segment`) on that block; what crosses ranks sits in `Hydro`'s hooks:

- `_halo`: the contributions of the ranks sharing an assembled L-vector's
  dofs (a subclass's exchange);
- `_dot_h1`: the owned entries' products, all-reduced (each shared dof is
  counted by its one owner); `_dot_l2`: all-reduced (L2 data is
  element-local);
- `_qupdate`: the dt estimate all-reduced to the minimum;
- `_guard_finite`: the finite check on the all-reduced state sum;
- `energies`, `e_norm` all-reduced; `save_checkpoint` writes the global
  state from rank 0.

So every host decision (dt accept or reject, a CG's stop and its flag
reads, the finite guard) reads a value that is the same on every rank,
and the ranks stay in lockstep.  The velocity CG is Jacobi whatever
`precond` says (the Kronecker inverse and the Schwarz blocks are not
block-local), as in `laghos_tpu.parallel.slab_hydro` (:403).  No
collective sits inside a CUDA graph: the views' CGs run eagerly.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import checkpoint
from ..hydro import Hydro
from ..timing import host_read
from . import segment

# scalar attributes a view takes over from the global Hydro unchanged
_SAME = ("opt", "dtype", "dim", "nq1", "NQ", "nd1", "l1d", "ld",
         "source", "use_visc", "use_vort", "p_assembly", "h0", "ftz_eps2",
         "_tables_cpu")


class RankView(Hydro):
    """The rank's block of the global Hydro `h` over the group `comm`;
    subclasses fill the layout (`_layout`) and the exchange (`_halo`)."""

    def __init__(self, h: Hydro, comm, NE: int, ndof: int):
        # a view shares the global Hydro's configuration and builds its
        # own arrays: Hydro.__init__ is not run
        self.h = h
        self.comm = comm
        self.device = comm.device
        for name in _SAME:
            setattr(self, name, getattr(h, name))
        self.NE, self.ndof = NE, ndof
        self.NE_global, self.ndof_global = h.NE, h.ndof
        self._init_run_state()
        # the global mesh and H1 space stay with h: a block has neither
        self.mesh = self.h1 = None
        self.tables = {k: self._dev(v) for k, v in h._tables_cpu.items()}
        self.tables["Winv"] = 1.0 / self.tables["W"]
        # views run partial assembly with Jacobi: no FA data, no Schwarz
        self.oz = self._sm = self.gather = self._inc = self._incmask = None
        self._schwarz = self._h1_csr = self.Me_inv = self._fa_dinv = None
        self.fa_setup_seconds = 0.0
        self._lat = self._lat_dims = self._edims = None
        self._lat_oz = self._lat32 = None
        self.one_l2 = torch.ones((NE, self.ld), dtype=self.dtype,
                                 device=self.device)
        self._owned_by_dtype = {}
        # the CGs sum their dots across the ranks
        self._cg_dot_h1, self._cg_dot_l2 = self._dot_h1, self._dot_l2

    # ------------------------------------------------------- layout --
    def _layout(self, rank: int):
        """(global dof ids, global element ids) of `rank`'s block, in the
        block's local order."""
        raise NotImplementedError

    def _set_elements(self, els):
        """The element data of global elements `els` (local order)."""
        h, dt = self.h, self.dtype
        self.massD = self._dev(h.massD.cpu()[els])
        self.rho0DetJ0w = h.rho0DetJ0w[els]
        self.rho0DetJ0w_t = self._dev(torch.tensor(self.rho0DetJ0w, dtype=dt))
        self.gamma_t = self._dev(h.gamma_t.cpu()[els])
        self.Jac0inv = h.Jac0inv[els]
        J0 = torch.tensor(self.Jac0inv, dtype=dt)
        if self.dim == 3:
            # (9, NE, NQ) component stack for the 3D q-update kernel
            J0 = J0.reshape(len(els), self.NQ, 9).permute(2, 0, 1)
        self.Jac0inv_t = self._dev(J0)
        self._e0 = h.S0["e"].cpu()[els]

    def _set_dofs(self, dofs, owned):
        """The dof data of global dofs `dofs` (local order), of which this
        rank owns those where `owned` (bool) holds."""
        h = self.h
        self.h1_dinv = self._dev(h.h1_dinv.cpu()[dofs])
        # (a column selection of a NumPy array is laid out column-major:
        # copy it C-contiguous, or every tensor it masks inherits that
        # layout and its sums change order)
        self.ess_mask = np.ascontiguousarray(h.ess_mask[:, dofs])
        self.ess_mask_t = self._dev(torch.as_tensor(self.ess_mask))
        self.rt_rhs = (None if h.rt_rhs is None
                       else self._dev(h.rt_rhs.cpu()[:, dofs]))
        self.owned = self._dev(torch.as_tensor(owned, dtype=self.dtype))
        self.S0 = {"x": self._dev(h.S0["x"].cpu()[:, dofs]),
                   "v": self._dev(h.S0["v"].cpu()[:, dofs]),
                   "e": self._dev(self._e0)}

    def to_global(self, S) -> dict:
        """The global state (the conforming Hydro's layout) of the rank
        states S, as CPU tensors on every rank; a collective."""
        parts = self.comm.all_gather(
            {k: S[k].detach().cpu() for k in ("x", "v", "e")})
        d, dt = self.dim, self.dtype
        out = {"x": torch.zeros((d, self.ndof_global), dtype=dt),
               "v": torch.zeros((d, self.ndof_global), dtype=dt),
               "e": torch.zeros((self.NE_global, self.ld), dtype=dt)}
        for r, P in enumerate(parts):
            dofs, els = self._layout(r)
            out["x"][:, dofs] = P["x"]
            out["v"][:, dofs] = P["v"]
            out["e"][els] = P["e"]
        return out

    def from_global(self, G) -> dict:
        """This rank's block of the global state G, on its device."""
        dofs, els = self._layout(self.comm.rank)
        return {"x": self._dev(G["x"].cpu()[:, dofs]),
                "v": self._dev(G["v"].cpu()[:, dofs]),
                "e": self._dev(G["e"].cpu()[els])}

    # ------------------------------------------------- collectives --
    def _owned_w(self, dtype):
        w = self._owned_by_dtype.get(dtype)
        if w is None:
            w = self._owned_by_dtype[dtype] = self.owned.to(dtype)
        return w

    def _dot_h1(self, u, v):
        return self.comm.allreduce_sum(
            torch.sum(u * v * self._owned_w(u.dtype), dim=-1))

    def _dot_l2(self, u, v):
        return self.comm.allreduce_sum(torch.sum(u * v, dim=-1))

    def _qupdate(self, S):
        sJit, dtm = super()._qupdate(S)
        return sJit, self.comm.allreduce_min(dtm)

    def _guard_finite(self, S_new, dt_est):
        loc = (torch.sum(S_new["v"]) + torch.sum(S_new["e"])
               + torch.sum(S_new["x"]))
        ok = torch.isfinite(self.comm.allreduce_sum(loc))
        return torch.where(ok, dt_est, torch.zeros_like(dt_est))

    def energies(self, S):
        ie, ke = super().energies(S)
        tot = self.comm.allreduce_sum(torch.stack([ie, ke]))
        return tot[0], tot[1]

    def e_norm(self, S):
        loc = torch.sum(S["e"] * S["e"])
        return host_read(torch.sqrt(self.comm.allreduce_sum(loc)))

    def save_checkpoint(self, path, S, t, dt, step):
        G = self.to_global(S)
        if self.comm.rank == 0:
            checkpoint.save(path, G, t, dt, step)

    def run_segment(self, S, t, dt, ti, steps, sj, count_stage1, t_final,
                    max_steps, vis_steps, chk, on_reject=None):
        return segment.run_segment(self, S, t, dt, ti, steps, sj,
                                   count_stage1, t_final, max_steps,
                                   vis_steps, chk, on_reject=on_reject)


def block_ids(shape, slices) -> np.ndarray:
    """Flat C-order ids of the block `slices` of an array of `shape`."""
    return np.arange(int(np.prod(shape))).reshape(shape)[slices].reshape(-1)
