"""The port's distributed plumbing on gloo CPU ranks: the collectives and
the checked neighbour exchange (`parallel/comm.py`), rank failures and the
backend rules; the host-side layouts against the JAX package, exactly:
the Morton order (`partition`), the -epm mesh (`scaling`) and the generic
halo layout (`halo.build_layout`), whose exchange (`halo_exchange_add`)
must give every rank the global assembly at its dofs; and the collective
`batch.sweep(n_devices=2)`, every member bit for bit the single-rank
sweep's."""

import time

import numpy as np
import pytest
import torch

from laghos_tpu.fem import mesh as jmesh
from laghos_tpu.hydro import Hydro as JHydro
from laghos_tpu.hydro import Options as JOptions
from laghos_tpu.parallel import halo as jhalo
from laghos_tpu.parallel import partition as jpart
from laghos_tpu.parallel import scaling as jscal
from laghos_tpu_torch import batch
from laghos_tpu_torch.fem import mesh as tmesh
from laghos_tpu_torch.parallel import (comm, halo, partition, probes, runs,
                                       scaling)

torch.set_num_threads(1)

LAUNCH_TIMEOUT = 180.0


def test_collectives_and_exchange():
    out = comm.launch(probes.comm_probe, 3, "gloo", "cpu",
                      timeout=LAUNCH_TIMEOUT)
    for r, o in enumerate(out):
        assert (o["sum"], o["min"], o["max"]) == (6.0, 1.0, 3.0)
        want = {p for p in (r - 1, r + 1) if 0 <= p < 3}
        for got in o["got"]:
            assert set(got) == want
            for p, plane in got.items():
                assert plane.shape == (2, 3) and (plane == p).all()
        # one header round per (peer, dtype, shape): the second exchange
        # skips it
        assert o["checked"] == [len(want), len(want)]


@pytest.mark.parametrize("mismatch", ["dtype", "shape"])
def test_exchange_mismatch_raises(mismatch):
    """A float32 plane into a float64 receive (or a wrong shape) raises on
    both sides, before any plane moves, instead of delivering garbage."""
    with pytest.raises(RuntimeError, match="does not match") as err:
        comm.launch(probes.comm_probe, 2, "gloo", "cpu", mismatch,
                    timeout=LAUNCH_TIMEOUT)
    want = "float32" if mismatch == "dtype" else "(3, 3)"
    assert want in str(err.value)


def test_rank_failure_raises_with_traceback():
    with pytest.raises(RuntimeError, match="probe failure on rank 1"):
        comm.launch(probes.comm_probe, 3, "gloo", "cpu", None, 1,
                    timeout=LAUNCH_TIMEOUT)


def test_stalled_rank_times_out():
    """A rank that never reaches the collective its peers wait in makes the
    launch fail within its time limit instead of hanging."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish within 5 s"):
        comm.launch(probes.comm_probe, 2, "gloo", "cpu", None, None, 1,
                    timeout=5.0)
    assert time.monotonic() - t0 < 60.0


def test_backend_rules():
    assert comm.default_backend("cuda") == "nccl"
    assert comm.default_backend("cpu") == "gloo"
    with pytest.raises(ValueError, match="gloo"):
        comm.check_backend("nccl", "cpu", 2)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="--dist-backend gloo"):
        comm.check_backend("nccl", "cuda", cards + 1)
    with pytest.raises(ValueError, match="backend"):
        comm.check_backend("mpi", "cpu", 2)
    comm.check_backend("gloo", "cpu", 4)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA card is present")
def test_ranks_default_to_the_card():
    """Without a device argument the ranks run on the card, as every
    entry point of the port does: without one it raises."""
    with pytest.raises(RuntimeError, match="CUDA"):
        comm.launch(probes.comm_probe, 2, "gloo")
    with pytest.raises(ValueError, match="card"):
        comm.launch(probes.comm_probe, 2)
    with pytest.raises(ValueError, match="card"):
        with comm.single():
            pass


def test_single_rank_group_in_process():
    with comm.single("gloo", "cpu") as c:
        assert (c.rank, c.size, c.device.type) == (0, 1, "cpu")
        t = torch.tensor([2.5, -1.0], dtype=torch.float64)
        assert torch.equal(c.allreduce_sum(t), t)
        assert c.all_gather({"a": 1}) == [{"a": 1}]
        assert c.exchange({}) == {}


@pytest.mark.parametrize("dim", [2, 3])
def test_partition_matches_jax(dim):
    n = (3, 2, 2)[:dim]
    mj = jmesh.uniform_refine(jmesh.cartesian(dim, n, (1.0,) * dim))
    mt = tmesh.uniform_refine(tmesh.cartesian(dim, n, (1.0,) * dim))
    pts = np.random.default_rng(dim).random((50, dim))
    np.testing.assert_array_equal(partition.morton_codes(pts),
                                  jpart.morton_codes(pts))
    np.testing.assert_array_equal(partition.sfc_element_order(mt),
                                  jpart.sfc_element_order(mj))
    np.testing.assert_array_equal(partition.sfc_partition(mt).elems,
                                  jpart.sfc_partition(mj).elems)


def test_scaling_matches_jax():
    for n in (1, 6, 8, 12, 30, 64, 97):
        for d in (1, 2, 3):
            assert scaling._factor(n, d) == jscal._factor(n, d)
    for dim, nd, epm in ((2, 4, 6), (3, 2, 8), (3, 3, 12)):
        mt, nt, st = scaling.epm_mesh(dim, nd, epm, (1.0, 2.0, 3.0))
        mj, nj, sj = jscal.epm_mesh(dim, nd, epm, (1.0, 2.0, 3.0))
        assert (nt, st) == (nj, sj)
        assert mt.num_elems == nd * epm
        np.testing.assert_array_equal(mt.verts, mj.verts)
        np.testing.assert_array_equal(mt.elems, mj.elems)


def _hydros3d():
    """The mesh of the JAX package's halo test (2x2x4 elements)."""
    opt = dict(problem=1, blast_energy=2.0, cg_tol=1e-12)
    from laghos_tpu_torch.hydro import Hydro, Options
    ht = Hydro(tmesh.cartesian(3, (2, 2, 4), (1.0, 1.0, 1.0)),
               Options(**opt), device="cpu")
    hj = JHydro(jmesh.cartesian(3, (2, 2, 4), (1.0, 1.0, 1.0)),
                JOptions(**opt))
    return ht, hj


def test_build_layout_matches_jax():
    ht, hj = _hydros3d()
    np.testing.assert_array_equal(np.asarray(ht.h1.gather),
                                  np.asarray(hj.h1.gather))
    lt, lj = halo.build_layout(ht.h1, 4), jhalo.build_layout(hj.h1, 4)
    assert lt.D == lj.D == 4
    for k in range(4):
        n, ne = lt.loc_of_glob[k].size, lt.elems[k].size
        np.testing.assert_array_equal(lt.loc_of_glob[k],
                                      lj.glob_of_loc[k, :n])
        np.testing.assert_array_equal(lt.gather[k], lj.gather[k, :ne])
        assert lj.elem_valid[k, :ne].all() and not lj.elem_valid[k, ne:].any()
        np.testing.assert_array_equal(lt.owned[k], lj.owned[k, :n])
        np.testing.assert_array_equal(lt.ess[k], lj.ess[k, :, :n])
        np.testing.assert_array_equal(
            lt.send_next[k], lj.send_next[k, :lt.send_next[k].size])
        np.testing.assert_array_equal(
            lt.send_prev[k], lj.send_prev[k, :lt.send_prev[k].size])
        np.testing.assert_array_equal(
            lt.send_prev[k], lj.recv_prev[k, :lt.send_prev[k].size])
    # every dof owned exactly once; scatter/gather round trip
    counts = np.zeros(ht.ndof)
    for k in range(4):
        counts[lt.loc_of_glob[k]] += lt.owned[k]
    assert np.all(counts == 1.0)
    u = np.random.default_rng(0).normal(size=(3, ht.ndof))
    back = halo.gather_global(lt, halo.scatter_global(lt, u), ht.ndof)
    np.testing.assert_array_equal(back, u)
    # slabs thinner than an element layer share dofs beyond a neighbour
    with pytest.raises(ValueError, match="non-adjacent"):
        halo.build_layout(ht.h1, 16)
    with pytest.raises(ValueError, match="non-adjacent"):
        jhalo.build_layout(hj.h1, 16)


def test_halo_exchange_add_assembles():
    spec = {"mesh": ["-nx", "2", "-ny", "2", "-nz", "4", "-rs", "0"],
            "opt": dict(problem=1, blast_energy=2.0, cg_tol=1e-12)}
    for o in comm.launch(probes.halo_probe, 4, "gloo", "cpu", spec,
                         timeout=LAUNCH_TIMEOUT):
        np.testing.assert_allclose(o["local"], o["global"], rtol=1e-13,
                                   atol=1e-15)


@pytest.mark.parametrize("energies", [[0.25, 0.5], [0.25, 0.5, 1.0]],
                         ids=["even", "uneven"])
def test_sweep_over_two_ranks_is_bitwise_the_single_sweep(energies):
    """Each rank runs its share (1 and 1, or 1 and 2 members) and every
    rank returns the whole batch, bit for bit the one-rank sweep."""
    spec = {"mesh": ["-dim", "2", "-rs", "1"],
            "opt": dict(problem=1, blast_energy=0.25, cg_tol=1e-12)}
    h = runs.build_hydro(spec)
    ref = batch.sweep(h, batch.blast_states(h, energies), 0.1, max_steps=8)
    out = comm.launch(runs.sweep_ranks, 2, "gloo", "cpu", spec, energies,
                      0.1, 8, timeout=LAUNCH_TIMEOUT)
    B = len(energies)
    assert [o["share"] for o in out] == [(0, B // 2), (B // 2, B)]
    for o in out:
        for k in ("t", "dt", "steps", "crashed", "h1_iters", "l2_iters"):
            np.testing.assert_array_equal(o[k], ref[k].numpy())
        for k in ("x", "v", "e"):
            np.testing.assert_array_equal(o["S"][k], ref["S"][k].numpy())
