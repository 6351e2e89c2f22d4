"""Distributed runs: one process per rank on `torch.distributed`.

`comm` (process groups, collectives, neighbour exchanges, the spawner),
`partition` and `scaling` (element orders and meshes for -sfc and -epm),
`halo` (the generic owned-dof layout), the rank views of a `Hydro`
(`slab_hydro` for slabs and pencils of a raster mesh, `chunk_hydro` for
element chunks of any mesh, `sharding` for the replicated-vector mode and
`rank_view`, which picks a run's view) and `segment` (the device loop
across ranks); `runs` holds rank functions for `comm.launch`, `probes`
those of the distributed checks.
"""
