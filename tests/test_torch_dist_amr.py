"""The AMR variant across gloo CPU ranks (`parallel.sharding.shard_amr`,
`parallel.runs.run_amr_view`, `-amr -nd N`) against the JAX package's
single-device AMR run and the port's single rank.

The 2D trajectory of tests/test_torch_amr.py (`TRAJ`: 25 attempts that
refine and derefine, the velocity CG converged to 1e-12) over 2, 3 (16
elements -> 5/5/6, ragged chunks) and 4 ranks.  Bounds:
- against the JAX package: the records' events, steps, NE and refine /
  derefine counts exact, t and dt at 1e-12, |e| at 1e-10 (the bounds of
  `test_trajectory_matches_jax`);
- against the port's single rank: the same records, t, dt and |e| at
  1e-12, the final state at 1e-12 of its largest entry.  Over ranks the
  assembled vectors are sums of per-rank partial sums, another order than
  one rank's, so the two agree at round-off, not bitwise;
- bitwise: two runs at one world size; a 2-rank checkpoint resumed on 2
  ranks against the uninterrupted 2-rank run.
The slow tests hold the port on 8 ranks to the JAX package's `shard_amr`
on 8 virtual devices (|e| at 1e-12) and the port's `-amr -nd 2` CLI to the
JAX CLI's.
"""

import concurrent.futures
import contextlib
import io
import os
import re
import types

import numpy as np
import pytest
import torch

from laghos_tpu import cli as jcli
from laghos_tpu.amr import driver as jdrv
from laghos_tpu.amr.forest import Forest as JForest
from laghos_tpu.amr.solver import AMRHydro as JAMRHydro
from laghos_tpu.hydro import Options as JOptions
from laghos_tpu_torch import cli
from laghos_tpu_torch.amr import driver as tdrv
from laghos_tpu_torch.amr.forest import Forest
from laghos_tpu_torch.amr.solver import AMRHydro
from laghos_tpu_torch.hydro import Options
from laghos_tpu_torch.parallel import comm, runs
from laghos_tpu_torch.parallel.sharding import shard_amr

torch.set_num_threads(1)

LAUNCH_TIMEOUT = 300.0
TRAJ = dict(problem=1, blast_energy=0.25, order_v=2, order_e=1,
            cg_tol=1e-12, cg_max_iter=2000)
RUN = dict(t_final=0.8, vis_steps=5, deref_threshold=0.9, max_steps=24)
CKPT_ATTEMPTS = 12


def _traj_forest(F):
    f = F(2, (2, 2), (1.0, 1.0), max_depth=3)
    f.refine(list(f.leaf_list()))
    return f


def _forest_spec(f):
    return dict(dim=f.dim, base_n=f.base_n, sizes=f.sizes,
                max_depth=f.max_depth, leaves=list(f.leaf_list()))


def _spec(**run):
    return {"forest": _forest_spec(_traj_forest(Forest)), "h0": 0.25,
            "opt": TRAJ, "run": dict(RUN, **run)}


def _launch(R, specs):
    """Every rank's `run_amr_view` results of `specs`; the ranks agree on
    every record and bit of the global state."""
    outs = comm.launch(runs.run_amr_views, R, "gloo", "cpu", specs,
                       timeout=LAUNCH_TIMEOUT)
    for o in outs[1:]:
        for a, b in zip(o, outs[0]):
            assert a["trace"] == b["trace"]
            for k in "xve":
                assert np.array_equal(a["state"][k], b["state"][k])
    for o in outs:
        for a in o:
            assert not any(a["launches"].values()), a["launches"]
    return outs


def _records(got, ref, tol_e, tol_t=1e-12):
    """The traces' records equal in their events and counts, t and dt at
    tol_t, |e| at tol_e (relative)."""
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.keys() == b.keys()
        for k in a:
            if k in ("t", "dt", "e_norm"):
                tol = tol_e if k == "e_norm" else tol_t
                assert abs(a[k] - b[k]) <= tol * abs(b[k]), (k, a, b)
            else:
                assert a[k] == b[k], (a, b)


def _state_close(a, b, tol=1e-12):
    for k in "xve":
        A, B = np.asarray(a[k]), np.asarray(b[k])
        assert A.shape == B.shape
        assert np.abs(A - B).max() <= tol * np.abs(B).max(), k


def _jax_runs(path):
    """The JAX package's TRAJ run, and its checkpoint at attempt 12 in
    `path`."""
    tr = []
    res = jdrv.run_amr(JAMRHydro(_traj_forest(JForest), JOptions(**TRAJ),
                                 h0=0.25), trace=tr, **RUN)
    jdrv.run_amr(JAMRHydro(_traj_forest(JForest), JOptions(**TRAJ),
                           h0=0.25), trace=[], ckpt_path=path,
                 **dict(RUN, max_steps=CKPT_ATTEMPTS))
    return res, tr


@pytest.fixture(scope="module")
def runs_all(tmp_path_factory):
    """Every run of the file's gates, the rank launches in threads beside
    the JAX package's and the port's single-rank runs in this process:
    "jax" (summary, trace, checkpoint path), "single" (summary, trace,
    global state), "ranks" {R: every rank's results of its specs}: TRAJ on
    2 ranks (then 12 attempts with a checkpoint and that checkpoint
    resumed; then the JAX checkpoint resumed), twice on 3 ranks and once
    on 4; "ckpt" the 2-rank checkpoint's path."""
    path = str(tmp_path_factory.mktemp("ranks") / "ck.pkl")
    jpath = str(tmp_path_factory.mktemp("jax") / "ck.pkl")
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        fut = {R: pool.submit(_launch, R, specs) for R, specs in (
            (2, [_spec(), _spec(max_steps=CKPT_ATTEMPTS, ckpt_path=path,
                                ckpt_every=1000), dict(_spec(), ckpt=path)]),
            (3, [_spec(), _spec()]), (4, [_spec()]))}
        tr = []
        h = AMRHydro(_traj_forest(Forest), Options(**TRAJ), h0=0.25,
                     device="cpu")
        res = tdrv.run_amr(h, trace=tr, **RUN)
        xT, vT, e = h.global_state()
        single = res, tr, {"x": xT, "v": vT, "e": e}
        jax = _jax_runs(jpath) + (jpath,)
        fut["jax ckpt"] = pool.submit(_launch, 2, [dict(_spec(), ckpt=jpath)])
        out = {R: f.result() for R, f in fut.items()}
    return {"jax": jax, "single": single, "ranks": out, "ckpt": path}


@pytest.fixture(scope="module")
def ranks(runs_all):
    """Rank 0's results of the specs launched on R ranks, by R."""
    return {R: outs[0] for R, outs in runs_all["ranks"].items()}


@pytest.fixture(scope="module")
def jax_runs(runs_all):
    return runs_all["jax"]


@pytest.fixture(scope="module")
def single(runs_all):
    return runs_all["single"]


@pytest.mark.parametrize("R", [2, 3, 4])
def test_trajectory_over_ranks_matches_jax_and_one_rank(R, runs_all, ranks,
                                                        jax_runs, single):
    """TRAJ over R ranks: record for record the JAX package's run and the
    port's single rank; a refinement and a derefinement happen, and every
    rank's chunk is placed again at each mesh change (the chunks sum to
    the global NE and differ by at most one element)."""
    o = ranks[R][0]
    rj, tj, _ = jax_runs
    rs, ts, Ss = single
    _records(o["trace"], tj, 1e-10)
    _records(o["trace"], ts, 1e-12)
    assert (o["summary"]["steps"], o["summary"]["NE"]) == (rj["steps"],
                                                           rj["NE"])
    assert abs(o["summary"]["e_norm"] - rs["e_norm"]) <= 1e-12 * rs["e_norm"]
    _state_close(o["state"], Ss)
    changed = [r for r in o["trace"] if r.get("changed")]
    assert any(r["n_ref"] for r in changed)
    assert any(r["n_deref"] for r in changed)
    els = np.array([x[0]["elements"] for x in runs_all["ranks"][R]])
    assert els.shape[1] >= 1 + len(changed)
    assert all(len(set(row)) > 1 for row in els)
    assert (els.max(axis=0) - els.min(axis=0) <= 1).all()
    assert els.sum(axis=0)[0] == 16 and els.sum(axis=0)[-1] == rs["NE"]


def test_two_runs_bitwise_equal(ranks):
    a, b = ranks[3]
    assert a["trace"] == b["trace"]
    assert a["summary"]["e_norm"] == b["summary"]["e_norm"]
    for k in "xve":
        assert np.array_equal(a["state"][k], b["state"][k])


def test_checkpoint_resumes_bitwise_on_two_ranks(ranks, runs_all):
    """Rank 0 writes one checkpoint at attempt 12 (the JAX layout); the
    2-rank resume repeats the uninterrupted 2-rank run bit for bit."""
    full, resumed, path = ranks[2][0], ranks[2][2], runs_all["ckpt"]
    assert sorted(os.listdir(os.path.dirname(path))) == ["ck.pkl"]
    ck = tdrv.load_checkpoint(path)
    assert ck["e"].shape == (len(ck["forest"]["leaves"]), 4)
    assert resumed["trace"] == full["trace"]
    assert resumed["summary"]["e_norm"] == full["summary"]["e_norm"]
    for k in "xve":
        assert np.array_equal(resumed["state"][k], full["state"][k])


def test_rank_checkpoint_resumes_on_one_rank(ranks, runs_all):
    """The 2-rank checkpoint resumed on one rank agrees with the 2-rank run
    at 1e-12."""
    full, path = ranks[2][0], runs_all["ckpt"]
    ck = tdrv.load_checkpoint(path)
    h = tdrv.resume_amr_hydro(ck, Options(**TRAJ), device="cpu")
    tr = list(ck["trace"])
    res = tdrv.run_amr(h, trace=tr, resume=ck, **RUN)
    _records(tr, full["trace"], 1e-12)
    assert abs(res["e_norm"] - full["summary"]["e_norm"]) <= (
        1e-12 * full["summary"]["e_norm"])
    xT, vT, e = h.global_state()
    _state_close({"x": xT, "v": vT, "e": e}, full["state"])


def test_jax_checkpoint_resumes_on_two_ranks(ranks, jax_runs):
    """The JAX package's checkpoint at attempt 12, resumed on 2 ranks,
    continues the JAX run: records at 1e-12 (t, dt, |e|)."""
    o = ranks["jax ckpt"][0]
    rj, tj, _ = jax_runs
    _records(o["trace"], tj, 1e-12)
    assert abs(o["summary"]["e_norm"] - rj["e_norm"]) <= 1e-12 * rj["e_norm"]


def test_fewer_elements_than_ranks_raises():
    """NE < world size raises ValueError: at distribution, at a placement
    after a derefinement (no collective runs before either check), and in
    the CLI before any rank starts."""
    fake = types.SimpleNamespace(rank=0, size=8, device=torch.device("cpu"))
    small = Forest(2, (2, 2), (1.0, 1.0), max_depth=1)
    with pytest.raises(ValueError, match="4 elements cannot be split over 8"):
        shard_amr(AMRHydro(small, Options(**TRAJ), h0=0.25, device="cpu"),
                  fake)
    h = shard_amr(AMRHydro(_traj_forest(Forest), Options(**TRAJ), h0=0.25,
                           device="cpu"), fake)
    assert h.ctx["gather"].shape[0] == 2 and h.state["e"].shape[0] == 2
    h.forest.derefine([k for k in h.forest.leaf_list() if k[0] == 1])
    h._build_space_arrays()
    h.x0_T = h.space["coords"][h.space["true_ids"]].T
    z = np.zeros((2, h.nt))
    with pytest.raises(ValueError, match="4 elements cannot be split over 8"):
        h._rebuilt(h._build_geometry(), z, z, np.zeros((h.NE, h.ld)))
    with pytest.raises(ValueError, match="cannot be split over 8 ranks"):
        cli.main(["-d", "cpu", "-amr", "-m", "square01_quad", "-rs", "0",
                  "-nd", "8"])


# ------------------------------------------------------------------- CLI --
_LINE = re.compile(r"step\s+(\d+),\s+t = ([\d.]+),\s+dt = ([\d.]+),\s+"
                   r"\|e\| = ([\deE+.-]+)\s+NE=(\d+)")
CLI_ARGS = ["-p", "1", "-m", "square01_quad", "-rs", "2", "-tf", "0.8",
            "-amr", "-ms", "11", "-vs", "2"]


def _cli_out(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = main(argv)
    return buf.getvalue(), res


def _same_cli(out, ref, tol):
    """The zone-count line, the step lines (step, t, dt, NE exact, |e| at
    `tol`) and the Refined / Derefined lines of two CLI outputs."""
    zones = [ln for ln in ref.splitlines() if ln.startswith("Number of")]
    assert zones and zones == [ln for ln in out.splitlines()
                               if ln.startswith("Number of")]
    a, b = _LINE.findall(out), _LINE.findall(ref)
    assert len(a) == len(b) >= 4
    for x, y in zip(a, b):
        assert (x[0], x[1], x[2], x[4]) == (y[0], y[1], y[2], y[4])
        assert abs(float(x[3]) - float(y[3])) <= tol * float(y[3])

    def events(text):
        return [ln for ln in text.splitlines()
                if ln.startswith(("Refined", "Derefined"))]
    assert events(out) == events(ref) and events(ref)


def test_cli_amr_over_ranks_prints_the_single_rank_lines():
    """`-amr -nd 2 --dist-backend gloo` prints the single-rank `-amr` run's
    lines (which test_cli_amr_matches_jax holds to the JAX CLI)."""
    ref, _ = _cli_out(cli.main, ["-d", "cpu"] + CLI_ARGS)
    res = cli.main(["-d", "cpu"] + CLI_ARGS + ["-nd", "2",
                                               "--dist-backend", "gloo"])
    _same_cli(res["log"], ref, 1e-10)
    assert [r["rank"] for r in res["ranks"]] == [0, 1]
    assert sum(r["NE"] for r in res["ranks"]) == res["NE"]
    assert not any(v for r in res["ranks"] for v in r["launches"].values())


# ------------------------------------------------------------------ slow --
@pytest.mark.slow
def test_eight_ranks_match_jax_shard_amr():
    """tests/test_amr.py:129-153's configuration: the port on 8 ranks
    against the JAX package's shard_amr over 8 virtual devices."""
    from laghos_tpu.parallel.sharding import device_mesh
    from laghos_tpu.parallel.sharding import shard_amr as jshard_amr

    opt = dict(problem=1, blast_energy=0.25, cg_tol=1e-12)
    run = dict(t_final=1.0, max_steps=25, vis_steps=1000)

    def build(F):
        f = F(2, (2, 2), (1.0, 1.0), max_depth=2)
        for _ in range(2):
            f.refine([k for k in f.leaf_list() if all(v == 0 for v in k[1])],
                     balance=False)
        return f

    hj = JAMRHydro(build(JForest), JOptions(**opt), h0=0.25)
    jshard_amr(hj, device_mesh(8))
    rj = jdrv.run_amr(hj, **run)
    spec = {"forest": _forest_spec(build(Forest)), "h0": 0.25, "opt": opt,
            "run": run}
    o = _launch(8, [spec])[0][0]["summary"]
    assert (o["steps"], o["NE"]) == (rj["steps"], rj["NE"])
    assert abs(o["e_norm"] - rj["e_norm"]) <= 1e-12 * rj["e_norm"]


@pytest.mark.slow
def test_cli_amr_over_ranks_matches_the_jax_cli():
    """The port's `-amr -nd 2` against the JAX CLI's `-amr -nd 2` (GSPMD
    over 2 of the conftest's 8 virtual CPU devices)."""
    ref, _ = _cli_out(jcli.main, ["--device", "cpu", "-nd", "2"] + CLI_ARGS)
    res = cli.main(["-d", "cpu", "-nd", "2"] + CLI_ARGS)
    _same_cli(res["log"], ref, 1e-10)
