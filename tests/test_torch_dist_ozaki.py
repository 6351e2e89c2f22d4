"""The Ozaki mode over ranks (`--ozaki` slabs and pencils): each block
runs the Ozaki lattice chains (ops/lattice_oz.py) with its own int8
splits, and the mixed-precision IR velocity solve with all-reduced dots.
The dt estimate of 4 slabs and of 2x2 pencils against the JAX package's
SlabHydro and the conforming runs at 1e-12 (`tests/test_slab_ozaki.py:
32-56`), and a short trajectory of 2 slabs against the port's single
rank at the JAX tests' bounds."""

import numpy as np
import pytest
import torch

from laghos_tpu.fem import mesh as jmesh
from laghos_tpu.hydro import Hydro as JHydro
from laghos_tpu.hydro import Options as JOptions
from laghos_tpu.parallel.slab_hydro import SlabHydro as JSlabHydro
from laghos_tpu_torch.parallel import comm, probes, runs
from laghos_tpu_torch.parallel.slab_hydro import SlabHydro

from test_torch_dist_slab import (LAUNCH_TIMEOUT, assert_close, port_ranks,
                                  port_single, spec)

torch.set_num_threads(1)


def oz_spec(**kw):
    return spec(ozaki=True, **kw)


@pytest.fixture(scope="module")
def jax_dt():
    m = jmesh.uniform_refine(jmesh.cartesian(3, (2, 2, 2), (1.0,) * 3))
    h = JHydro(m, JOptions(**oz_spec()["opt"]))
    assert h._lat_oz is not None and h.opt.cg_ir
    return h, float(h.dt_estimate(h.S0))


@pytest.mark.parametrize("shape", [(4,), (2, 2)], ids=["slab", "pencil"])
def test_ozaki_dt_estimate_matches_jax(jax_dt, shape):
    h, dt1 = jax_dt
    dtj = float(JSlabHydro(h, mesh_shape=shape).dt_estimate(
        JSlabHydro(h, mesh_shape=shape).S0))
    assert abs(dtj - dt1) / dt1 < 1e-12
    out = comm.launch(probes.view_dt, 4, "gloo", "cpu",
                      dict(oz_spec(), mesh_shape=shape),
                      timeout=LAUNCH_TIMEOUT)
    for o in out:
        assert abs(o["dt"] - dt1) / dt1 < 1e-12
        assert abs(o["dt"] - dtj) / dtj < 1e-12


def test_ozaki_element_form_slabs_dt_estimate(jax_dt):
    """The Ozaki element form on each block (lattice_ops off): the dense
    Ozaki q-update of the slabs against the JAX package's conforming dt."""
    _, dt1 = jax_dt
    out = comm.launch(probes.view_dt, 2, "gloo", "cpu",
                      oz_spec(lattice_ops=False), timeout=LAUNCH_TIMEOUT)
    for o in out:
        assert abs(o["dt"] - dt1) / dt1 < 1e-12


def test_ozaki_slabs_match_single():
    sp = oz_spec(steps=3)
    got = port_ranks(sp, 2)
    assert_close(got, port_single(sp))


@pytest.mark.parametrize("ozaki", [True, False], ids=["ozaki", "native"])
def test_slab_world_one_rates_are_single_device_bits(ozaki):
    """A slab view at world size 1 runs the single device's operators: its
    rates on a perturbed state are the Hydro's bit for bit.  In the Ozaki
    mode that includes the energy CG's L2 mass apply, which runs Ozaki
    products on every path (the view took the native apply before)."""
    h = runs.build_hydro(spec(ozaki=ozaki))
    S = dict(h.S0)
    S["v"] = S["v"] + torch.tensor(0.1 * np.random.default_rng(0).normal(
        size=tuple(S["v"].shape)), dtype=h.dtype)
    with comm.single("gloo", "cpu") as c:
        view = SlabHydro(h, c)
        assert (view.oz is not None) == ozaki
        rates, dt, _ = view._mult(view.from_global(S))
        got = view.to_global(rates)
    want, dt1, _ = h._mult(S)
    for k in "xve":
        assert torch.equal(got[k], want[k]), k
    assert float(dt) == float(dt1)
