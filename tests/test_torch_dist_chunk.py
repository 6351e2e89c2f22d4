"""Element chunks and the replicated-vector mode over gloo CPU ranks
(`parallel/chunk_hydro.py`, `parallel/sharding.py`), on the gather path
(structured_el=False, lattice_ops=False), the element form the JAX
package's chunk tests run: a built-in mesh in Morton order split into 4
chunks and, ragged, 5, against the JAX package's ChunkHydro and the
port's single rank at the JAX tests' bounds; the replicated mode on 8
ranks at 1e-13 (`tests/test_driver.py:95-106`), against the port's single
rank and the JAX package's GSPMD sharding on 8 devices."""

import numpy as np
import pytest
import torch

from laghos_tpu import driver as jdriver
from laghos_tpu.fem import mesh as jmesh
from laghos_tpu.hydro import Hydro as JHydro
from laghos_tpu.hydro import Options as JOptions
from laghos_tpu.parallel.chunk_hydro import ChunkHydro as JChunkHydro
from laghos_tpu.parallel.partition import sfc_partition as jsfc
from laghos_tpu.parallel.sharding import device_mesh, shard_hydro
from laghos_tpu_torch.parallel import comm, runs
from laghos_tpu_torch.parallel.chunk_hydro import ChunkHydro

from test_torch_dist_slab import (assert_close, mesh_of, port_ranks,
                                  port_single)

torch.set_num_threads(1)

GATHER = dict(structured_el=False, lattice_ops=False)


def chunk_spec(refine, steps=8):
    return {"mesh": ["-m", "square01_quad", "-rs", str(refine), "-sfc"],
            "opt": dict(problem=1, blast_energy=0.25, ode_solver=4,
                        cg_tol=1e-12, **GATHER),
            "run": dict(t_final=0.8, max_steps=steps, vis_steps=5)}


def jax_run(sp, view):
    m = jmesh.cartesian(2, (2, 2), (1.0, 1.0))
    for _ in range(mesh_of(sp)[2]):
        m = jmesh.uniform_refine(m)
    m = jsfc(m)
    h = JHydro(m, JOptions(**sp["opt"]))
    r = jdriver.run(view(h), verbose=False, **sp["run"])
    return {"steps": r.steps, "t": r.t, "e_norm": r.e_norm,
            "energy_final": r.energy_final, "h1_iters": r.h1_iters}


def test_chunk_matches_jax_and_single():
    sp = chunk_spec(2)
    got = port_ranks(sp, 4)
    assert got["launches"]["lattice"] == 0
    assert_close(got, jax_run(sp, lambda h: JChunkHydro(h, n_devices=4)))
    assert_close(got, port_single(sp))


def test_chunk_ragged():
    """64 elements over 5 ranks: chunks of 12 and 13, no padding."""
    sp = chunk_spec(2, steps=6)
    got = port_ranks(sp, 5)
    ref = jax_run(sp, lambda h: JChunkHydro(h, n_devices=5))
    assert got["steps"] == ref["steps"]
    assert abs(got["e_norm"] - ref["e_norm"]) / ref["e_norm"] < 1e-11
    single = port_single(sp)
    assert_close(got, single)
    for k in ("x", "v", "e"):
        scale = np.abs(single["S"][k]).max()
        assert np.abs(got["S"][k] - single["S"][k]).max() <= 1e-11 * scale


def test_replicated_mode_8_ranks():
    """The JAX package's `test_driver.py:95-106` case: 2D Sedov on 4x2
    elements, -cgt 1e-14, 5 steps, on 8 ranks."""
    sp = {"mesh": ["-dim", "2", "-nx", "4", "-ny", "2", "-rs", "0"],
          "opt": dict(problem=1, cg_tol=1e-14),
          "run": dict(t_final=0.6, max_steps=5, vis_steps=1)}
    got = port_ranks(sp, 8, halo=False)
    single = port_single(sp)
    assert got["steps"] == single["steps"]
    assert abs(got["e_norm"] - single["e_norm"]) / single["e_norm"] < 1e-13
    m = jmesh.cartesian(2, (4, 2), (1.0, 1.0))
    hj = shard_hydro(JHydro(m, JOptions(**sp["opt"])), device_mesh(8))
    rj = jdriver.run(hj, t_final=0.6, max_steps=5, vis_steps=1)
    assert got["steps"] == rj.steps
    assert abs(got["e_norm"] - rj.e_norm) / rj.e_norm < 1e-13


def test_chunk_refuses_too_many_ranks_and_full_assembly():
    h = runs.build_hydro({"mesh": ["-dim", "2", "-nx", "2", "-ny", "1",
                                   "-rs", "0"],
                          "opt": dict(problem=1)})
    fa = runs.build_hydro({"mesh": ["-dim", "2", "-rs", "0"],
                           "opt": dict(problem=1, p_assembly=False)})
    with comm.single("gloo", "cpu") as c:
        c.size = 3                   # the check runs before any collective
        with pytest.raises(ValueError, match="cannot be split"):
            ChunkHydro(h, c)
        with pytest.raises(ValueError, match="partial-assembly"):
            ChunkHydro(fa, c)
