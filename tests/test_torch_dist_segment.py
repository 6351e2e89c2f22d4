"""The distributed device loop (`parallel/segment.py`): over gloo CPU
ranks, `driver.run(device_loop=True)` on a rank view repeats the view's
host loop bit for bit (steps, t, dt, the sampled |e| steps, CG totals and
the final state) for slabs, pencils, RK2Avg slabs and element chunks, as
`tests/test_segment.py` asks of the JAX package."""

import numpy as np
import pytest
import torch

from test_torch_dist_slab import port_ranks, spec

torch.set_num_threads(1)


@pytest.mark.parametrize("R,shape,kw", [
    (4, None, {}),
    (4, (2, 2), {}),
    (4, None, {"ode_solver": 7}),
    (3, None, {"structured_el": False, "lattice_ops": False}),
], ids=["slab", "pencil", "slab_rk2avg", "chunk"])
def test_device_loop_matches_host_loop(R, shape, kw):
    sp = spec(steps=6, **kw)
    sp["run"]["vis_steps"] = 4
    host = port_ranks(sp, R, mesh_shape=shape)
    sp["run"]["device_loop"] = True
    dev = port_ranks(sp, R, mesh_shape=shape)
    for k in ("steps", "t", "dt", "e_norm", "norms", "h1_iters",
              "l2_iters"):
        assert dev[k] == host[k], k
    for k in ("x", "v", "e"):
        np.testing.assert_array_equal(dev["S"][k], host["S"][k])
