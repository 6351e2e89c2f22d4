"""The rank views of a Hydro, picked as the JAX CLI picks its distribution.

`rank_view` is the one map from a run's distribution flags to a rank view:
with --halo, slabs (pencils) of a raster mesh and element chunks of any
other mesh; without it the replicated-vector mode, the JAX CLI's `-nd N`
without --halo.

`laghos_tpu.parallel.sharding.shard_hydro` places a Hydro's element arrays
over the device mesh and replicates its L-vectors; GSPMD compiles each
assembly into an all-reduce of the devices' whole L-vectors (its comment
at :48-52).  The port runs that layout explicitly as a case of the chunk
view: every rank holds the whole L-vectors and one contiguous element
chunk, and an assembly all-reduces the ranks' L-vectors.

`laghos_tpu.parallel.sharding.shard_amr` places an AMRHydro's element
arrays over the device mesh after every rebuild; `shard_amr` here runs
that layout with a process per rank (below).
"""

from __future__ import annotations

import functools

from .chunk_hydro import ChunkHydro
from .slab_hydro import SlabHydro


def shard_hydro(hydro, comm) -> ChunkHydro:
    """The replicated-vector view of the global `hydro` for this rank of
    `comm`."""
    return ChunkHydro(hydro, comm, replicated=True)


def rank_view(hydro, comm, halo: bool, mesh_shape=None):
    """This rank's view of the global `hydro`: with `halo` the slabs of a
    raster mesh over the rank grid `mesh_shape` (default: comm.size slabs;
    two axes: pencils) and element chunks of any other mesh, without it
    the replicated layout."""
    if not halo:
        return shard_hydro(hydro, comm)
    if hydro._sm is not None:
        return SlabHydro(hydro, comm, mesh_shape)
    return ChunkHydro(hydro, comm)


def shard_amr(hydro, comm):
    """Distribute the AMRHydro `hydro` over the ranks of `comm` (in place;
    returns it).  Every rank holds an identical `hydro`, built the same way
    (the forest operations are deterministic), and calls this once after
    construction.

    The layout is the one the JAX package's placement compiles to
    (`laghos_tpu/parallel/sharding.py:79-132`):
    - rank r of D holds elements [r NE // D, (r + 1) NE // D) of the
      current leaf order (unpadded contiguous chunks, differing by at most
      one element): their element-axis arrays (`solver.ELEMENT_KEYS`),
      energy, and node -> (element, local node) incidence;
    - every rank holds the whole node and true-dof data: the state x and v
      as (d, nt), the P / P^T tables, the essential mask and the forest;
    - the constrained mass apply and the velocity right-hand side assemble
      the chunk, apply P^T and all-reduce the partial (d, nt) vector, the
      only collective inside a CG iteration, whose dots then run on
      vectors equal on every rank; the dt estimate is all-reduced to the
      minimum, |e|'s square to the sum, the refinement indicators
      all-gathered into the global (NE,) arrays, and the energy chunks
      all-gathered before a transfer or a checkpoint;
    - after every mesh change the rebuilt arrays are placed again over the
      new leaf order (`_on_rebuild`): re-placement is the load rebalance.

    The arrays are built on the host; only the rank's chunk and the
    whole-mesh node data go to `comm.device`.  Raises ValueError when the
    mesh has fewer elements than ranks, here or after a derefinement."""
    if hydro.comm is not None:
        raise ValueError("the AMRHydro is distributed already")
    host = {k: v.cpu() for k, v in hydro.ctx.items()
            if k not in ("inc", "inc_mask")}
    S = [hydro.state[k].cpu() for k in ("x", "v", "e")]
    hydro.comm = comm
    hydro.move_to(comm.device)
    hydro._on_rebuild = functools.partial(_place_amr_ctx, hydro)
    _place_amr_ctx(hydro, host, *S)
    return hydro


def _place_amr_ctx(hydro, host, xT, vT, e):
    """Place a build of `hydro` (host arrays, the global state) as this
    rank's element chunk and the whole node data."""
    D, NE = hydro.comm.size, hydro.NE
    if NE < D:
        raise ValueError(f"{NE} elements cannot be split over {D} ranks")
    r = hydro.comm.rank
    hydro._place(host, xT, vT, e, r * NE // D, (r + 1) * NE // D)
