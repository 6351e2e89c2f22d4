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

`shard_amr` (the AMR variant across ranks) is not ported yet (ROADMAP
A11b).
"""

from __future__ import annotations

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
