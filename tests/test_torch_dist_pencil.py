"""Pencils (a 2D rank grid) over gloo CPU ranks: 3D Sedov on 4x4x4
elements over 2x2 ranks against the JAX package's SlabHydro at the same
rank grid, the port's single rank and the port's 4 slabs (the corner and
edge sums of the two-hop halo must be exact), a 2D mesh split along both
axes, and the pencil layout's global-state round trip."""

import numpy as np
import torch

from laghos_tpu_torch.parallel import comm, probes, runs

from test_torch_dist_slab import (LAUNCH_TIMEOUT, assert_close, jax_slab,
                                  port_ranks, port_single, spec)

torch.set_num_threads(1)


def test_pencil_matches_jax_single_and_slab_3d_sedov():
    sp = spec(steps=6)
    got = port_ranks(sp, 4, mesh_shape=(2, 2))
    assert_close(got, jax_slab(sp, mesh_shape=(2, 2)))
    assert_close(got, port_single(sp))
    slab = port_ranks(sp, 4)
    assert got["steps"] == slab["steps"]
    assert abs(got["e_norm"] - slab["e_norm"]) / slab["e_norm"] < 1e-12


def test_pencil_2d_both_axes():
    sp = spec(dim=2, refine=2, steps=6)
    got = port_ranks(sp, 4, mesh_shape=(2, 2))
    single = port_single(sp)
    assert got["steps"] == single["steps"]
    assert abs(got["e_norm"] - single["e_norm"]) / single["e_norm"] < 1e-11


def test_pencil_global_state_roundtrip():
    sp = spec()
    h = runs.build_hydro(sp)
    for o in comm.launch(probes.view_roundtrip, 4, "gloo", "cpu",
                         dict(sp, mesh_shape=(2, 2)), timeout=LAUNCH_TIMEOUT):
        assert o["back_equal"]
        for k in ("x", "v", "e"):
            np.testing.assert_array_equal(o["S"][k], h.S0[k].numpy())
