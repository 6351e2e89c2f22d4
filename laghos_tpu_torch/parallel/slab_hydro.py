"""Structured domain decomposition: slabs and pencils of a raster mesh.

The port's counterpart of `laghos_tpu.parallel.slab_hydro`, the image of
the reference's MPI decomposition (laghos_solver.cpp:362-398):

- the raster-ordered Cartesian mesh is split into contiguous element
  SLABS along its slowest axis (`mesh_shape=(Dz,)`) or PENCILS along its
  two slowest axes (`mesh_shape=(Dz, Dy)`); each rank's dofs are a
  contiguous block of lattice planes, sharing one plane with each
  neighbour per partitioned axis;
- each rank runs the single-device operators on its block: in 3D the
  whole-lattice banded operators (ops/lattice.py, the q-lattice CUDA
  kernel; with --ozaki the Ozaki chains of ops/lattice_oz.py and the
  mixed-precision IR velocity solve), in 2D and without lattice_ops the
  element form on the block's own structured transforms (the element
  CUDA kernel in 3D);
- after each H1 assembly the ranks swap boundary planes, one exchange per
  partitioned axis in sequence, so that the second axis's planes carry
  the first's sums and the contributions of diagonal neighbours arrive in
  two hops (`_halo`); dots and the dt estimate are all-reduced
  (parallel/view.py).

A dof on the first lattice plane of a partitioned axis belongs to the
lower neighbour, when there is one; applied per axis, so every shared
edge and corner has one owner.  L2 (energy) data is element-local and
never communicated (laghos_solver.cpp:442-518).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..hydro import dense_oz
from ..ops import lattice as lop
from ..ops import lattice_oz as lzo
from ..ops import structured
from ..ops import tensor as top
from .view import RankView, block_ids


def element_grid(mesh):
    """Element counts per axis, slowest first ((z, y, x) or (y, x)), of a
    raster Cartesian mesh; None for any other mesh."""
    found = structured._raster_positions(mesh)
    return None if found is None else tuple(reversed(found[0]))


def check_partition(grid, mesh_shape):
    """Raise ValueError unless the rank grid `mesh_shape` (slowest axis
    first) splits the element grid `grid` (slowest first) evenly."""
    mesh_shape = tuple(int(x) for x in mesh_shape)
    if len(mesh_shape) > len(grid):
        raise ValueError(f"rank grid {mesh_shape}: more partitioned axes "
                         f"than mesh dimensions ({len(grid)})")
    for i, Dk in enumerate(mesh_shape):
        if Dk < 1 or grid[i] % Dk != 0:
            raise ValueError(
                f"partitioned element-grid axis {grid[i]} must be divisible "
                f"by the rank-grid axis {Dk} (element grid {grid}, slowest "
                f"first; rank grid {mesh_shape})")


def _identity_structmaps(dims_loc, p):
    ndof = int(np.prod([n * p + 1 for n in dims_loc]))
    ne = int(np.prod(dims_loc))
    ident = np.arange(ndof, dtype=np.int32)
    e_id = np.arange(ne, dtype=np.int32)
    return structured.StructMaps(dims=tuple(dims_loc), p=p, perm=ident,
                                 inv=ident, e_mesh_at_raster=e_id,
                                 e_raster_at_mesh=e_id)


class SlabHydro(RankView):
    """One rank's slab or pencil of the global `Hydro` `h`, over the group
    `comm` laid out as the rank grid `mesh_shape` (default: comm.size
    slabs); rank r holds tile r of the grid in C order."""

    def __init__(self, h, comm, mesh_shape=None):
        if h._sm is None:
            raise ValueError("slab mode needs a raster-ordered Cartesian "
                             "mesh (structured transforms active)")
        if not h.p_assembly:
            raise ValueError("slab mode covers the partial-assembly path")
        mesh_shape = tuple(int(x) for x in (mesh_shape or (comm.size,)))
        if int(np.prod(mesh_shape)) != comm.size:
            raise ValueError(f"rank grid {mesh_shape} needs "
                             f"{int(np.prod(mesh_shape))} ranks, the group "
                             f"has {comm.size}")
        p = h.opt.order_v
        self.grid = tuple(reversed(h._sm.dims))          # slowest first
        check_partition(self.grid, mesh_shape)
        self.mesh_shape = mesh_shape
        self.grid_loc = tuple(n // (mesh_shape[i] if i < len(mesh_shape)
                                    else 1)
                              for i, n in enumerate(self.grid))
        self.latg = tuple(n * p + 1 for n in self.grid)
        self.latg_loc = tuple(n * p + 1 for n in self.grid_loc)
        self._tiles = list(itertools.product(*[range(Dk)
                                               for Dk in mesh_shape]))
        self.tile = self._tiles[comm.rank]
        super().__init__(h, comm, int(np.prod(self.grid_loc)),
                         int(np.prod(self.latg_loc)))
        dofs, els = self._layout(comm.rank)
        self._set_elements(els)
        # ownership: the first plane of a partitioned axis belongs to the
        # lower neighbour
        owned = np.ones(self.latg_loc, dtype=bool)
        for i, k in enumerate(self.tile):
            if k > 0:
                owned[(slice(None),) * i + (0,)] = False
        self._set_dofs(dofs, owned.reshape(-1))
        self.dims_loc = tuple(reversed(self.grid_loc))   # fastest first
        self._sm = _identity_structmaps(self.dims_loc, p)
        if self.dim == 3 and h._lat is not None:
            self._build_lattice()
        if h.opt.ozaki:
            # the element operators' splits, built on every path as Hydro
            # builds them: the lattice form takes its chains from _lat_oz,
            # and the energy CG applies the L2 mass with these on both
            self.oz = dense_oz(self._np("H1B"), self._np("H1G"),
                               self._np("L2B"), self.dim, self.device)

    def _np(self, name):
        return self._tables_cpu[name].double().numpy()

    def _build_lattice(self):
        """The block's whole-lattice tables and q-lattice constants (its
        own banded tables: the block is itself a raster lattice); Jacobi
        only.  In Ozaki mode the block's int8 splits and the f32 shadow for
        the IR inner sweeps."""
        built = lop.build_lattice_ops(self, self._dev_cast)
        built.pop("kron", None)
        built.pop("kron_relerr", None)
        self._lat_dims = built.pop("lat_dims")
        self._lat = built
        self._edims = self._sm.dims
        self.Jac0inv_t = None          # the lattice holds its own stack
        if self.opt.ozaki:
            l2bd, _ = top.dense_ops(self._np("L2B"),
                                    np.zeros_like(self._np("L2B")), 3)
            self._lat_oz = lzo.build_lattice_oz(
                self._np("H1B"), self._np("H1G"), l2bd, self.grid_loc,
                n_slices=self.opt.ozaki_slices, device=self.device)
            self._lat32 = {
                "Ts": lop.cast_tables(built["Ts"], torch.float32),
                "Dq": built["Dq"].float()}

    def _dev_cast(self, t):
        return self._dev(t.to(self.dtype))

    def _layout(self, rank):
        tile = self._tiles[rank]
        p = self.opt.order_v
        dsl, esl = [], []
        for i, k in enumerate(tile):
            n = self.grid_loc[i]
            dsl.append(slice(k * n * p, (k + 1) * n * p + 1))
            esl.append(slice(k * n, (k + 1) * n))
        return (block_ids(self.latg, tuple(dsl)),
                block_ids(self.grid, tuple(esl)))

    def _neighbour(self, axis, step):
        tile = list(self.tile)
        tile[axis] += step
        return int(np.ravel_multi_index(tile, self.mesh_shape))

    def _halo(self, y):
        """Add the neighbours' shares of the block's boundary planes, one
        partitioned axis after the other (the second exchange carries the
        first's sums, so corners arrive in two hops).  Both planes sent
        along an axis are read before either sum is added."""
        shp = y.shape
        nlat = len(self.latg_loc)
        y = y.reshape(tuple(shp[:-1]) + self.latg_loc)
        for i, Dk in enumerate(self.mesh_shape):
            if Dk == 1:
                continue
            ax = y.dim() - nlat + i
            L = self.latg_loc[i]
            k = self.tile[i]
            sends = {}
            if k > 0:
                prev = self._neighbour(i, -1)
                sends[prev] = y.select(ax, 0)
            if k < Dk - 1:
                nxt = self._neighbour(i, 1)
                sends[nxt] = y.select(ax, L - 1)
            got = self.comm.exchange(sends)
            y = y.clone()
            if k > 0:
                y.select(ax, 0).add_(got[prev])
            if k < Dk - 1:
                y.select(ax, L - 1).add_(got[nxt])
        return y.reshape(shp)
