"""The port's tracer (`timing.trace`) and the phase timers folded into its
hook, on the CPU, on the 3D lattice and gather paths at rs0: with the
tracer off no profiler range is opened; on or off, and timed or not, the
trajectory is the same bit for bit; under torch.profiler every attempt is
one "laghos.step" range holding its layers' ranges; the read counter
equals its formula from the CG iteration counts; the CLI's -f table and
--profile trace."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from laghos_tpu_torch import cli, driver, timing
from laghos_tpu_torch import hydro as thydro
from laghos_tpu_torch.fem import mesh as tmesh
from laghos_tpu_torch.hydro import Hydro, Options

torch.set_num_threads(1)

PATHS = {"lattice": {},
         "gather": dict(structured_el=False, lattice_ops=False)}
SPANS = ("laghos.step", "laghos.dt_read", "laghos.vis", "laghos.qdata",
         "laghos.force", "laghos.cg_h1", "laghos.cg_l2")


def _hydro(path):
    return Hydro(tmesh.cartesian(3, (2, 2, 2), (1.0, 1.0, 1.0)),
                 Options(problem=1, ode_solver=7, cg_tol=1e-11,
                         precond="jacobi", **PATHS[path]), device="cpu")


def _rejecting(h):
    """Run arguments that resume from S0 at 3x the stable dt: the first
    attempts are rejected (0.85 backoff), then the run goes on."""
    dt0, _ = h.dt_estimate_full(h.S0)
    return dict(t_init=0.0, dt_init=3.0 * float(dt0), step_init=1)


def _assert_same(a, b):
    assert (a.steps, a.t, a.dt) == (b.steps, b.t, b.dt)
    for k in ("x", "v", "e"):
        assert torch.equal(a.S[k], b.S[k]), k
    assert a.norms == b.norms
    assert (a.h1_iters, a.l2_iters, a.quad_steps) == (
        b.h1_iters, b.l2_iters, b.quad_steps)
    assert (a.energy_init, a.energy_final, a.e_norm) == (
        b.energy_init, b.energy_final, b.e_norm)


def _ranges(prof):
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.name.startswith("laghos."))


@pytest.mark.parametrize("path", sorted(PATHS))
def test_tracing_off_opens_no_range(path, monkeypatch):
    """Off, the hooks open no record_function (one raising in its place
    is never called) and a profiler sees no program range."""
    def refuse(*a, **kw):
        raise AssertionError("record_function called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    h = _hydro(path)
    assert timing.TRACER is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        driver.run(h, 0.6, max_steps=2, **_rejecting(h))
        driver.run(h, 0.6, max_steps=2, device_loop=True)
    assert _ranges(prof) == []


@pytest.mark.parametrize("loop", ["host", "device"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_traced_trajectory_is_the_untraced_one(path, loop):
    h = _hydro(path)
    kw = dict(max_steps=12, vis_steps=3, device_loop=loop == "device",
              **_rejecting(h))
    off = driver.run(h, 0.6, **kw)
    with timing.trace() as tr:
        on = driver.run(h, 0.6, **kw)
    _assert_same(off, on)
    assert timing.TRACER is None and timing.last_trace() is tr
    rejected = [s for s, ok in tr.attempts if not ok]
    assert rejected and len(tr.attempts) == off.steps + len(rejected)
    # a rejected attempt is tried again at the same step
    steps = [s for s, _ in tr.attempts]
    assert steps == sorted(steps)
    assert set(steps) == set(range(1, off.steps + 1))


@pytest.mark.parametrize("path", sorted(PATHS))
def test_step_ranges_nest_the_layers(path):
    """One laghos.step an attempt, holding 2 cg_h1, 2 cg_l2 and 4 force
    ranges (RK2Avg's two stages), one dt_read, and 3 qdata ranges where
    stage 1 recomputes its q-data (after a rejection, and in the first
    step of a resumed run), else 2 (stage 2 and the final estimate)."""
    h = _hydro(path)
    kw = _rejecting(h)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.trace() as tr:
            r = driver.run(h, 0.6, max_steps=8, vis_steps=4, **kw)
    ranges = _ranges(prof)
    assert {n for _, _, n in ranges} == set(SPANS)
    steps = [(s, t) for s, t, n in ranges if n == "laghos.step"]
    assert len(steps) == len(tr.attempts)
    inside = sum(1 for s, t, n in ranges if n != "laghos.step"
                 and any(a <= s and t <= b for a, b in steps))
    assert inside == len(ranges) - len(steps)
    prev_ok = False
    for (a, b), (_, ok) in zip(steps, tr.attempts):
        got = {n: 0 for n in SPANS}
        for s, t, n in ranges:
            if a < s and t <= b:
                got[n] += 1
        assert got["laghos.step"] == 0
        assert (got["laghos.cg_h1"], got["laghos.cg_l2"],
                got["laghos.force"], got["laghos.dt_read"]) == (2, 2, 4, 1)
        assert got["laghos.qdata"] == (2 if prev_ok else 3)
        prev_ok = ok
    assert sum(n == "laghos.vis" for _, _, n in ranges) == len(r.norms)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_read_counter_formula(path, monkeypatch):
    """The reads by innermost range: a CG solve reads its flag once an
    iteration and once more to stop (its columns' largest count + 1); the
    driver reads dt_est each attempt, the two CG counts each accepted step
    and |e| each vis step; outside every range, the energies at both ends
    and |e| at the end."""
    flags = {"h1": 0, "l2": 0}
    real = thydro.cg

    def counted(apply_A, b, *a, **kw):
        res = real(apply_A, b, *a, **kw)
        site = "h1" if b.shape[0] == 3 else "l2"
        flags[site] += int(res.iters.max()) + 1
        return res

    monkeypatch.setattr(thydro, "cg", counted)
    h = _hydro(path)
    kw = _rejecting(h)
    with timing.trace() as tr:
        r = driver.run(h, 0.6, max_steps=8, vis_steps=3, **kw)
    n_ok = tr.accepted()
    assert n_ok == r.steps and n_ok < len(tr.attempts)
    assert dict(tr.reads) == {
        "laghos.cg_h1": flags["h1"], "laghos.cg_l2": flags["l2"],
        "laghos.dt_read": len(tr.attempts), "laghos.step": 2 * n_ok,
        "laghos.vis": len(r.norms), "": 2 + 3}
    by = tr.reads_by_layer()
    assert (by["qdata"], by["force"]) == (0, 0)
    assert by["driver"] == len(tr.attempts) + 2 * n_ok + len(r.norms) + 5
    assert "host reads" in tr.summary()


@pytest.mark.parametrize("path", sorted(PATHS))
def test_timed_run_is_the_untimed_run(path, monkeypatch):
    """driver.run(timing=True): the untimed trajectory bit for bit, every
    phase timer charged, and the FOM counts of every attempt's phases:
    the CG iterations of each solve (the energy CG's count at least 1) and
    the elements of each q-update inside the loop."""
    its = {"h1": 0, "l2": 0}
    real = thydro.cg

    def counted(apply_A, b, *a, **kw):
        res = real(apply_A, b, *a, **kw)
        if b.shape[0] == 3:
            its["h1"] += int(res.iters.sum())
        else:
            its["l2"] += max(int(res.iters[0]), 1)
        return res

    h = _hydro(path)
    for kw in (dict(), _rejecting(h)):
        off = driver.run(h, 0.6, max_steps=6, **kw)
        monkeypatch.setattr(thydro, "cg", counted)
        its.update(h1=0, l2=0)
        calls = h.qupdate_calls
        on = driver.run(h, 0.6, max_steps=6, timing=True, **kw)
        monkeypatch.setattr(thydro, "cg", real)
        _assert_same(off, on)
        tim = on.timing_data
        assert set(tim.t) == {"cgH1", "cgL2", "force", "qdata"}
        assert all(v > 0 for v in tim.t.values())
        assert (tim.H1iter, tim.L2iter) == (its["h1"], its["l2"])
        assert isinstance(tim.H1iter, int) and isinstance(tim.L2iter, int)
        # the fresh run's first dt estimate is outside the loop: not timed
        timed = h.qupdate_calls - calls - (0 if kw else 1)
        assert tim.quad_tstep == h.NE * timed
        if not kw:
            assert (tim.H1iter, tim.L2iter) == (on.h1_iters, on.l2_iters)
        assert timing.TRACER is None


def test_cli_fom_table_and_profile(tmp_path, monkeypatch, capsys):
    """-f prints the FOM table; --profile writes a trace holding the
    layer ranges and prints the reads by layer."""
    monkeypatch.chdir(tmp_path)
    cli.main(["-d", "cpu", "-p", "1", "-dim", "3", "-rs", "0", "-ms", "2",
              "-s", "7", "--precond", "jacobi", "-f", "--profile",
              str(tmp_path / "prof")])
    out = capsys.readouterr().out
    assert "| Ranks | Zones" in out and "CG (H1) total time" in out
    line = next(x for x in out.splitlines() if x.startswith("Tracer: "))
    assert "cg_h1" in line and "attempts 3 (3 accepted" in line
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"laghos.step", "laghos.cg_h1", "laghos.cg_l2"} <= names


def test_fa_spmv_range_and_counters():
    """Under -fa: every sparse product runs in a "laghos.spmv" range
    nested in a "laghos.cg_h1" one, one before the first iteration of a
    solve and one an iteration; the tracer counts each coupled velocity
    solve and its iterations on the eager path; the timed run's timers
    are the phases alone, which print_timing and the FOM sum; with the
    tracer off nothing is counted."""
    h = Hydro(tmesh.cartesian(3, (2, 2, 2), (1.0, 1.0, 1.0)),
              Options(problem=1, ode_solver=7, cg_tol=1e-11,
                      p_assembly=False), device="cpu")
    key = ("laghos.cg_h1", "generic")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.trace() as tr:
            r = driver.run(h, 0.6, max_steps=4, vis_steps=4)
    ranges = _ranges(prof)
    spmv = [(s, t) for s, t, n in ranges if n == "laghos.spmv"]
    cg_h1 = [(s, t) for s, t, n in ranges if n == "laghos.cg_h1"]
    assert spmv and all(any(a <= s and t <= b for a, b in cg_h1)
                        for s, t in spmv)
    assert set(tr.cg_iters) == set(tr.cg_solves) == {key}
    assert tr.cg_iters[key] == r.h1_iters
    assert tr.cg_solves[key] == 2 * len(tr.attempts) == len(cg_h1)
    assert len(spmv) == tr.cg_iters[key] + tr.cg_solves[key]
    assert tr.reads_by_layer()["cg_h1"] == tr.reads["laghos.cg_h1"] > 0

    timed = driver.run(h, 0.6, max_steps=4, timing=True)
    tim = timed.timing_data
    assert set(tim.t) == {"cgH1", "cgL2", "force", "qdata"}
    got = timing.print_timing(tim, steps=timed.steps, H1_dofs=3 * h.ndof,
                              L2_dofs=h.NE * h.ld, NQ=h.NQ, NE=h.NE,
                              p_assembly=False, dim=3, fom_table=False,
                              out=lambda *a: None)
    assert got["TT"] == tim.t["cgH1"] + tim.t["force"] + tim.t["qdata"]
    last = timing.last_trace()
    assert last.cg_solves[key] == 2 * len(last.attempts)

    counts = (dict(last.cg_iters), dict(last.cg_solves))
    driver.run(h, 0.6, max_steps=2)
    assert timing.TRACER is None and timing.last_trace() is last
    assert counts == (dict(last.cg_iters), dict(last.cg_solves))
