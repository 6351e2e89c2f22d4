"""Slabs of a raster mesh over gloo CPU ranks (`parallel/slab_hydro.py`):
the 3D Sedov run of `tests/test_slab.py` (4x4x4 elements, 4 slabs, RK4,
-cgt 1e-12) and the 2D Taylor-Green and RT-gravity runs (2 slabs) against
the JAX package's `SlabHydro` at the same layout and against the port's
single rank, at the JAX tests' bounds: steps equal, t within 1e-13, |e|
and total energy within 1e-11 relative, CG-H1 iterations within 1 %; the
RK2Avg drift under 1e-11, the global-state round trip exact, and bad
partitions refused."""

import numpy as np
import pytest
import torch

from laghos_tpu import driver as jdriver
from laghos_tpu.fem import mesh as jmesh
from laghos_tpu.hydro import Hydro as JHydro
from laghos_tpu.hydro import Options as JOptions
from laghos_tpu.parallel.slab_hydro import SlabHydro as JSlabHydro
from laghos_tpu_torch import cli, driver
from laghos_tpu_torch.parallel import comm, probes, runs
from laghos_tpu_torch.parallel.slab_hydro import SlabHydro, check_partition

torch.set_num_threads(1)

LAUNCH_TIMEOUT = 200.0
SEDOV = dict(problem=1, blast_energy=2.0, ode_solver=4, cg_tol=1e-12,
             precond="jacobi")


def spec(dim=3, refine=1, steps=8, t_final=0.6, **opt):
    """(2,)*dim elements refined `refine` times, as the CLI's mesh flags."""
    return {"mesh": ["-dim", str(dim), "-rs", str(refine)],
            "opt": dict(SEDOV, **opt),
            "run": dict(t_final=t_final, max_steps=steps, vis_steps=5)}


def mesh_of(sp):
    """(dim, element counts, refinements) of the spec's CLI mesh flags."""
    a = cli.build_parser().parse_args(sp["mesh"])
    return a.dim, (a.nx, a.ny, a.nz)[:a.dim], a.rs


def port_single(sp):
    """The port's single-rank run of the spec, in this process."""
    h = runs.build_hydro(sp)
    r = driver.run(h, **sp["run"])
    return {"steps": r.steps, "t": r.t, "e_norm": r.e_norm,
            "energy_final": r.energy_final, "h1_iters": r.h1_iters,
            "S": {k: v.numpy() for k, v in r.S.items()}}


def port_ranks(sp, R, halo=True, mesh_shape=None):
    """The spec's run over R gloo CPU ranks, as the CLI picks the views
    (halo: slabs of a raster mesh, chunks of any other; else replicated)."""
    out = comm.launch(runs.run_view, R, "gloo", "cpu",
                      dict(sp, halo=halo, mesh_shape=mesh_shape),
                      timeout=LAUNCH_TIMEOUT)
    for o in out[1:]:              # the same summary on every rank
        assert (o["steps"], o["e_norm"]) == (out[0]["steps"],
                                             out[0]["e_norm"])
    return out[0]


def jax_slab(sp, **kw):
    dim, n, refine = mesh_of(sp)
    m = jmesh.cartesian(dim, n, (1.0,) * dim)
    for _ in range(refine):
        m = jmesh.uniform_refine(m)
    h = JHydro(m, JOptions(**sp["opt"]))
    r = jdriver.run(JSlabHydro(h, **kw), verbose=False, **sp["run"])
    return {"steps": r.steps, "t": r.t, "e_norm": r.e_norm,
            "energy_final": r.energy_final, "h1_iters": r.h1_iters}


def assert_close(a, b, iters=True):
    assert a["steps"] == b["steps"]
    assert abs(a["t"] - b["t"]) < 1e-13
    assert abs(a["e_norm"] - b["e_norm"]) / b["e_norm"] < 1e-11
    assert (abs(a["energy_final"] - b["energy_final"])
            / abs(b["energy_final"]) < 1e-11)
    if iters:
        assert abs(a["h1_iters"] - b["h1_iters"]) <= 0.01 * b["h1_iters"]


def test_slab_matches_jax_and_single_3d_sedov():
    sp = spec()
    got = port_ranks(sp, 4)
    assert_close(got, jax_slab(sp, n_devices=4))
    single = port_single(sp)
    assert_close(got, single)
    for k in ("x", "v", "e"):
        scale = np.abs(single["S"][k]).max()
        assert np.abs(got["S"][k] - single["S"][k]).max() <= 1e-11 * scale
    # the lattice path on every rank: the q-lattice kernel's wrapper ran
    assert got["launches"]["element"] == 0 and got["NE"] == 16


def test_slab_element_form_3d():
    """Without the lattice operators each 3D block runs the element form
    (its own structured transforms, the element-layout q-update)."""
    sp = spec(steps=4, lattice_ops=False)
    got = port_ranks(sp, 2)
    assert got["launches"]["lattice"] == 0
    assert_close(got, port_single(sp))


def test_slab_global_state_roundtrip():
    sp = spec()
    h = runs.build_hydro(sp)
    for o in comm.launch(probes.view_roundtrip, 4, "gloo", "cpu", sp,
                         timeout=LAUNCH_TIMEOUT):
        assert o["back_equal"]
        for k in ("x", "v", "e"):
            np.testing.assert_array_equal(o["S"][k], h.S0[k].numpy())


def test_slab_rk2avg_energy_conservation():
    sp = spec(dim=2, refine=2, steps=10, ode_solver=7)
    r = port_ranks(sp, 4)
    drift = abs(r["energy_final"] - r["energy_init"]) / abs(r["energy_init"])
    assert drift < 1e-11


@pytest.mark.parametrize("problem,t_final", [(0, 0.75), (7, 4.0)],
                         ids=["taylor_green", "rt_gravity"])
def test_slab_2d_sources(problem, t_final):
    """The Taylor-Green forcing and the RT gravity RHS over 2 slabs (the
    element form on each block in 2D, as in the JAX package)."""
    blast = 1.0 if problem == 0 else SEDOV["blast_energy"]
    sp = spec(dim=2, refine=2, steps=6, t_final=t_final, problem=problem,
              blast_energy=blast)
    got = port_ranks(sp, 2)
    ref = jax_slab(sp, n_devices=2)
    assert got["steps"] == ref["steps"]
    assert abs(got["e_norm"] - ref["e_norm"]) / ref["e_norm"] < 1e-11
    single = port_single(sp)
    assert got["steps"] == single["steps"]
    assert abs(got["e_norm"] - single["e_norm"]) / single["e_norm"] < 1e-11


def test_bad_partitions_raise():
    with pytest.raises(ValueError, match="divisible"):
        check_partition((4, 4, 4), (3,))
    with pytest.raises(ValueError, match="divisible"):
        check_partition((4, 4, 4), (2, 3))
    with pytest.raises(ValueError, match="more partitioned axes"):
        check_partition((4, 4), (2, 2, 1))
    h = runs.build_hydro(spec())
    with comm.single("gloo", "cpu") as c:
        with pytest.raises(ValueError, match="needs 2 ranks"):
            SlabHydro(h, c, mesh_shape=(2,))
        with pytest.raises(ValueError, match="raster"):
            SlabHydro(runs.build_hydro(dict(spec(), opt=dict(
                SEDOV, structured_el=False, lattice_ops=False))), c)
    # the JAX package refuses the same partition
    with pytest.raises(ValueError):
        jax_slab(spec(), n_devices=3)


@pytest.mark.parametrize("halo,shape,dim,opt", [
    (True, None, 3, {}),
    (True, (1, 1), 3, {"ozaki": True}),
    (True, None, 2, {}),
    (True, None, 3, {"structured_el": False, "lattice_ops": False}),
    (False, None, 3, {}),
], ids=["slab", "pencil_ozaki", "slab_2d", "chunk", "replicated"])
def test_views_have_every_hydro_attribute(halo, shape, dim, opt):
    """A rank view does not run Hydro.__init__: it must still set every
    attribute a Hydro of the same options has, so that an inherited method
    never meets a missing one."""
    from laghos_tpu_torch.parallel.sharding import rank_view

    h = runs.build_hydro(spec(dim=dim, **opt))
    with comm.single("gloo", "cpu") as c:
        view = rank_view(h, c, halo, shape)
    assert not set(vars(h)) - set(vars(view))
