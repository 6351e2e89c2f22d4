"""One run of a cell: set-up, the measured window, the traced phases and
the check of the window's steps.

The window drives the user's host loop, `laghos_tpu_torch.driver.run`,
on a `Hydro` built in set-up from the cell's configuration and traffic:
adaptive dt, rejection with rollback, and `Hydro.advance` (q-update,
force, the velocity and energy CGs, the RK2Avg combine).  One call of the
loop runs from `Hydro.S0` through the warm-up steps, which close the
set-up, and on through the window.  The loop calls the hook after every
accepted step (`vis_steps=1`), at its own per-step sync: the hook reads
the clock there, so a step's time holds any rejected attempts before it,
and it ends the window by raising once `seconds` have passed.
"""

from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import check, profiling, registry

_BIG = 10 ** 9


class _WindowClosed(Exception):
    pass


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def shape_of(config):
    """The sizes an operation's work is counted from."""
    s = config["sizes"]
    n, p, pe, d = (s["elements_per_axis"], config["order_v"],
                   config["order_e"], config["dim"])
    nq1 = (3 * p + pe - 1) // 2 + 1
    return {"dim": d, "order_v": p, "order_e": pe, "nq1": nq1,
            "elements": s["elements"], "q_per_element": nq1 ** d,
            "h1_lattice": [n * p + 1] * d, "q_lattice": [n * nq1] * d,
            "dtype_bytes": {"f64": 8, "f32": 4}[config["dtype"]],
            "dtype": config["dtype"]}


def build_hydro(config, traffic, blast_energy, device, dtype):
    """The configuration's `Hydro`, built as the CLI builds it."""
    from laghos_tpu_torch import data
    from laghos_tpu_torch.fem import mesh as fmesh
    from laghos_tpu_torch.hydro import Hydro, Options

    m = data.get_mesh(config["mesh"])
    for _ in range(config["rs"]):
        m = fmesh.uniform_refine(m)
    opt = Options(problem=config["problem"], order_v=config["order_v"],
                  order_e=config["order_e"], cfl=config["cfl"],
                  cg_tol=config["cg_tol"], cg_max_iter=config["cg_max_iter"],
                  p_assembly=config["partial_assembly"],
                  blast_energy=blast_energy,
                  ode_solver=config["ode_solver"],
                  precond=traffic["precond"])
    h = Hydro(m, opt, dtype=dtype, device=device)
    s = config["sizes"]
    got = (h.NE, h.ndof * h.dim, h.NE * h.ld, h.NE * h.NQ)
    want = (s["elements"], s["h1_dofs"], s["l2_dofs"], s["q_points"])
    if got != want:
        raise RuntimeError(f"the Hydro's sizes {got} are not the "
                           f"configuration's {want}")
    return h


class Keeper:
    """Copies of chosen states of the window.  On the card each goes to
    pinned host memory allocated in set-up, copied on a side stream while
    the next step runs, so it neither holds the program's device memory
    nor waits for the copy."""

    def __init__(self, like, count):
        self.cuda = like["x"].is_cuda
        self.kept = {}
        if self.cuda:
            self.side = torch.cuda.Stream(like["x"].device)
            self.free = [{k: torch.empty(v.shape, dtype=v.dtype,
                                         pin_memory=True)
                          for k, v in like.items()} for _ in range(count)]

    def keep(self, step, S):
        if not self.cuda:
            self.kept[step] = {k: v.clone() for k, v in S.items()}
            return
        buf = self.free.pop()
        self.side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.side):
            for k, v in S.items():
                buf[k].copy_(v, non_blocking=True)
                v.record_stream(self.side)
        self.kept[step] = buf

    def states(self):
        if self.cuda:
            self.side.synchronize()
        return self.kept


@dataclass
class Hook:
    """The `on_vis` of the run: the step clock, the window's edges and the
    states the check will need."""

    t0: float
    warmup: int
    seconds: float
    fracs: list
    keeper: Keeper = None
    ts: list = field(default_factory=lambda: [0.0])
    clock: list = field(default_factory=list)
    step_s: list = field(default_factory=list)
    start: float = None
    setup_s: float = None
    wanted: dict = None          # window step -> global step, to copy
    samples: list = None         # global steps g of the samples
    last: tuple = None           # (step, t, S) of the last accepted step

    def __call__(self, ti, t, S):
        now = time.perf_counter()
        self.ts.append(t)
        self.last = (ti, t, S)
        if ti < self.warmup:
            self.clock.append(now)
            return
        if ti == self.warmup:
            self.start = now
            self.setup_s = now - self.t0
        else:
            self.step_s.append(now - self.clock[-1])
        self.clock.append(now)
        j = ti - self.warmup
        if j in self.wanted:
            self.keeper.keep(ti, S)
        if (now - self.start >= self.seconds
                and j >= max(self.wanted, default=0)):
            raise _WindowClosed

    def plan(self, span):
        """Samples at window steps 2 + fraction x (span - 2), the
        fractions drawn from the seed: a seed checks the same steps in
        every run, whatever the speed of the program."""
        ms = sorted({2 + int(f * (span - 2)) for f in self.fracs})
        self.samples = [self.warmup + m for m in ms]
        self.wanted = {}
        for m in ms:
            for j in (m - 2, m - 1, m):
                self.wanted[j] = self.warmup + j


@dataclass
class TraceData:
    """What the traced phases read, for the per-layer metric readers."""

    shape: dict
    peaks: dict
    stages: int      # the configuration's rhs_per_step: each evaluation
                     # solves the velocity (a CG a component) and the energy
    profile: dict = None
    phases: dict = None
    timed_steps: int = 0
    h1_iters: int = 0
    l2_iters: int = 0
    syncs_per_step: float = None

    def ms_per_step(self, phase):
        """ms an accepted step of a fenced phase timer of the timed
        steps; None where they did not run."""
        if not self.timed_steps or self.phases is None:
            return None
        return 1e3 * self.phases[phase] / self.timed_steps

    def roofline_pct(self, op_name):
        """The share of the least time of an operation's applies in the
        profiled steps (the larger of its bytes at the HBM peak and its
        operations at the dtype's peak) in the device time of its
        kernels; None where none ran."""
        if self.profile is None:
            return None
        op = registry.op(op_name)
        us, calls = 0.0, 0
        for name, (t, n) in self.profile["kernels"].items():
            if any(k in name for k in op.KERNELS):
                us += t
            if op.CALL in name:
                calls += n
        if us <= 0 or calls == 0:
            return None
        nbytes, nops = op.work(self.shape)
        least = nbytes / self.peaks["hbm_bytes_per_s"]["value"]
        if nops is not None:
            least = max(least, nops / self.peaks["flops_per_s"][
                self.shape["dtype"]]["value"])
        return 100.0 * calls * least / (us / 1e6)


def _continue(driver, h, t_final, last, dt, steps, **kw):
    """The host loop resumed from the accepted step `last` = (step, t, S)
    for `steps` more attempts."""
    step, t, S = last
    return driver.run(h, t_final, max_steps=steps, S_init=S, t_init=t,
                      dt_init=dt, step_init=step + 1, **kw)


def _traced(driver, timing, h, config, traffic, last, dt, tr):
    """The traced phases after the window, each resuming the trajectory:
    steps under torch.profiler with a host mark at the end of each step;
    steps with the program's fenced phase timers (`driver.run(timing=
    True)`, whose first step also recomputes its stage-1 q-data, as every
    resumed run does); and two runs under the program's sync counter,
    whose difference is the syncs of their extra steps alone."""
    from torch.profiler import ProfilerActivity, profile

    tf = config["t_final"]
    cuda = last[2]["x"].is_cuda
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])

    def mark(ti, t, S):
        with torch.profiler.record_function(profiling.MARK):
            pass

    # the first resumed step recomputes its stage-1 q-data: the window
    # runs from its mark to the last, over profile_steps whole steps
    n = traffic["trace"]
    with profile(activities=acts) as prof:
        res = _continue(driver, h, tf, last, dt, n["profile_steps"],
                        vis_steps=1, on_vis=mark)
    tr.profile = profiling.window(prof)
    del prof
    last, dt = (res.steps, res.t, res.S), res.dt

    res = _continue(driver, h, tf, last, dt, n["timed_steps"] - 1,
                    vis_steps=_BIG, timing=True)
    tr.timed_steps = res.steps - last[0]
    tr.phases = dict(res.timing_data.t)
    tr.h1_iters, tr.l2_iters = res.h1_iters, res.l2_iters
    last, dt = (res.steps, res.t, res.S), res.dt

    if cuda:
        counted = []
        for k in (0, n["sync_steps"]):
            with timing.count_syncs() as c:
                res = _continue(driver, h, tf, last, dt, k, vis_steps=_BIG)
            counted.append((res.steps - last[0], c["syncs"]))
            last, dt = (res.steps, res.t, res.S), res.dt
        (s1, c1), (s2, c2) = counted
        if s2 > s1:
            tr.syncs_per_step = (c2 - c1) / (s2 - s1)


def run(cell, seed, seconds, trace, device, t0, dtype=None):
    """One run of `cell`; returns the result line's dict (without the
    checks' log, which goes to stderr)."""
    from laghos_tpu_torch import driver, timing

    config, traffic = cell.config, cell.traffic
    rng = np.random.default_rng(seed)
    lo, hi = traffic["blast_energy"]
    E0 = float(rng.uniform(lo, hi))
    fracs = rng.random(traffic["samples"]).tolist()
    dev = torch.device(device)
    if dtype is None:
        dtype = {"f64": torch.float64, "f32": torch.float32}[config["dtype"]]
    build_s = 0.0
    marks = [("start", t0), ("imports", time.perf_counter())]
    if dev.type == "cuda":
        from laghos_tpu_torch.ops import kernels

        torch.cuda.init()
        marks.append(("CUDA init", time.perf_counter()))
        build_s = kernels.build().seconds
        marks.append(("kernel library", time.perf_counter()))
    log(f"cell {cell.name}, seed {seed}: E0 = {E0!r}; kernel library built "
        f"in {build_s:.3f} s (0 when found built)")
    h = build_hydro(config, traffic, E0, dev, dtype)
    marks.append(("Hydro", time.perf_counter()))
    keeper = Keeper(h.S0, 3 * traffic["samples"])
    marks.append(("pinned buffers", time.perf_counter()))
    hook = Hook(t0=t0, warmup=traffic["warmup_steps"], seconds=seconds,
                fracs=fracs, keeper=keeper)
    hook.plan(traffic["sample_span_steps"])
    finished = False
    try:
        driver.run(h, config["t_final"], vis_steps=1, on_vis=hook)
        finished = True
    except _WindowClosed:
        pass
    if hook.start is None:
        raise RuntimeError("the run ended before its warm-up did")
    marks.append(("warm-up steps", hook.start))
    log("set-up by phase: " + ", ".join(
        f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in zip(marks, marks[1:])))
    if finished:
        log(f"the run reached t_final = {config['t_final']} after "
            f"{len(hook.step_s)} window steps")
    window_s = hook.clock[-1] - hook.start
    n = len(hook.step_s)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    s = config["sizes"]
    # FOM0's dof count (laghos_tpu_torch/timing.py:75, laghos_solver.cpp:727)
    # over the window's wall time, not over the fenced phase sum
    metrics = {
        "fom": 1e-6 * (s["h1_dofs"] + s["l2_dofs"]) * n / window_s,
        "step_ms_p90": float(np.percentile(hook.step_s, 90)) * 1e3,
        "peak_mem_gib": peak / 2 ** 30,
        "setup_s": hook.setup_s,
    }
    ts = hook.ts
    rejected = sum(check.after_reject(ts, g)
                   for g in range(len(ts) - n, len(ts)))
    log(f"set-up {hook.setup_s:.3f} s; window: {n} accepted steps in "
        f"{window_s:.4f} s (t {ts[-n - 1]:.6g} -> {ts[-1]:.6g}), "
        f"{rejected} of them after a rejected attempt; step ms p50 p75 "
        f"p90 p95 max over {n} samples "
        + " ".join(f"{1e3 * float(np.percentile(hook.step_s, q)):.4f}"
                   for q in (50, 75, 90, 95, 100)) + f"; peak {peak} B")

    tr = None
    if trace:
        tr = TraceData(shape=shape_of(config), peaks=registry.peaks(),
                       stages=config["rhs_per_step"])
        step, t, _ = hook.last
        _traced(driver, timing, h, config, traffic, hook.last,
                t - hook.ts[step - 1], tr)

    # the check: the program's state freed first, then the reference
    S0 = {k: v.to("cpu") for k, v in h.S0.items()}
    states = keeper.states()
    samples = {g: tuple(states[g - i] for i in (2, 1, 0))
               for g in hook.samples if all(g - i in states for i in (0, 1, 2))}
    del h, hook, keeper, states
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref_mod = registry.reference(config["reference"])
    t_ref = time.perf_counter()
    ref = ref_mod.build(config, E0, dev)
    to = lambda S: {k: v.to(dev) for k, v in S.items()}  # noqa: E731
    correct, checked, failed, checks = check.compare(
        ref, to(S0), {g: tuple(to(S) for S in v) for g, v in samples.items()},
        ts, config["limits"], log=log)
    log(f"reference check: {checked} states, {failed} over a limit, "
        f"{time.perf_counter() - t_ref:.3f} s")

    out = {"correct": correct, "attempted": n, "failed": failed}
    if trace:
        got = {}
        for m in cell.per_layer:
            reader = registry.metric(m["name"])
            v = reader.read(tr)
            if v is not None:
                got[m["name"]] = {"value": v, "unit": m["unit"]}
        out["metrics"] = got
    else:
        out["metrics"] = {m["name"]: {"value": metrics[m["name"]],
                                      "unit": m["unit"]}
                          for m in cell.end_to_end}
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
              "count": cell.chips, "memory_peak_bytes": peak}
    if trace:
        device["busy_s"] = tr.profile["busy_us"] / 1e6
        device["window_s"] = tr.profile["window_us"] / 1e6
        out["breakdown"] = {"device_ops": tr.profile["device_ops"],
                            "idle_gaps": tr.profile["idle_gaps"]}
    out["device"] = device
    out["checks"] = checks
    return out
