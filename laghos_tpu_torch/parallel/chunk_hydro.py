"""Element-chunk domain decomposition, for meshes off the raster path.

The port's counterpart of `laghos_tpu.parallel.chunk_hydro`: the elements
are split into contiguous chunks of the mesh's element order (give an
unstructured mesh -sfc first, so that chunks are compact: parallel/
partition.py), and each rank holds its chunk's elements and only the dofs
they touch.  After each local assembly the dofs shared between chunks are
summed through ONE boundary buffer: the rank copies its shares into the
(C, NB) buffer (an indexed copy: a dof has one local slot on each rank, so
no scatter-add, which on CUDA would use atomics), all-reduces it and reads
the totals back.  A dof's owner is the lowest rank holding it.

With `replicated` every rank holds every dof and its contiguous element
chunk: the replicated-vector layout that GSPMD compiles the JAX package's
`shard_hydro` to (`laghos_tpu/parallel/sharding.py:48-52`), where an
assembly all-reduces the ranks' whole L-vectors (parallel/sharding.py).

The JAX package pads ragged chunks with phantom elements and a phantom
dof block so that every device has one shape under shard_map; a process
per rank holds its own unpadded arrays instead (chunks differ by at most
one element).
"""

from __future__ import annotations

import numpy as np
import torch

from ..hydro import dense_oz
from ..ops import mass as mop
from .view import RankView


class ChunkHydro(RankView):
    """One rank's element chunk of the global `Hydro` `h` over the group
    `comm` (the gather path's element operators on the chunk)."""

    def __init__(self, h, comm, replicated=False):
        if not h.p_assembly:
            raise ValueError("chunk mode covers the partial-assembly path")
        D, NE = comm.size, h.NE
        if NE < D:
            raise ValueError(f"{NE} elements cannot be split over {D} ranks")
        self.replicated = replicated
        bounds = [r * NE // D for r in range(D + 1)]
        self._els_of = [np.arange(bounds[r], bounds[r + 1]) for r in range(D)]
        gather = np.asarray(h.h1.gather)
        if replicated:
            self._dofs_of = [np.arange(h.ndof)] * D
        else:
            self._dofs_of = [np.unique(gather[e].reshape(-1))
                             for e in self._els_of]
        count = np.zeros(h.ndof, np.int64)
        owner = np.full(h.ndof, -1, np.int64)
        for r in range(D - 1, -1, -1):             # the lowest rank wins
            count[self._dofs_of[r]] += 1
            owner[self._dofs_of[r]] = r
        shared = np.flatnonzero(count >= 2)
        self.NB = shared.size
        bid = np.full(h.ndof, -1, np.int64)
        bid[shared] = np.arange(self.NB)

        k = comm.rank
        els, dofs = self._els_of[k], self._dofs_of[k]
        super().__init__(h, comm, els.size, dofs.size)
        self._set_elements(els)
        self._set_dofs(dofs, owner[dofs] == k)
        lgather = np.searchsorted(dofs, gather[els])
        self.gather = torch.as_tensor(lgather, dtype=torch.long,
                                      device=self.device)
        inc, msk = mop.build_incidence(lgather, dofs.size)
        self._inc = torch.as_tensor(inc, dtype=torch.long, device=self.device)
        self._incmask = self._dev(torch.tensor(msk, dtype=self.dtype))
        b = bid[dofs]
        on_b = np.flatnonzero(b >= 0)
        self._b_loc = torch.as_tensor(on_b, dtype=torch.long,
                                      device=self.device)
        self._b_ids = torch.as_tensor(b[on_b], dtype=torch.long,
                                      device=self.device)
        if h.opt.ozaki:
            self.oz = dense_oz(*(self._tables_cpu[n].double().numpy()
                                 for n in ("H1B", "H1G", "L2B")),
                               self.dim, self.device)

    def _layout(self, rank):
        return self._dofs_of[rank], self._els_of[rank]

    def _halo(self, y):
        """Sum the chunk-shared dofs' contributions through the boundary
        buffer: indexed copy in, all-reduce, indexed copy out."""
        if self.NB == 0:
            return y
        buf = y.new_zeros(tuple(y.shape[:-1]) + (self.NB,))
        buf[..., self._b_ids] = y[..., self._b_loc]
        tot = self.comm.allreduce_sum(buf)
        y = y.clone()
        y[..., self._b_loc] = tot[..., self._b_ids]
        return y
