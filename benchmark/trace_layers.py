"""Every millisecond of a cell's step put down to a layer, and what the
program's tracer costs, on the card.

    python3 benchmark/trace_layers.py --workload NAME --seed N \
        [--seconds 30] [--steps 4] [--cost-steps 24] [--out FILE]

Builds the cell as benchmark/run.py does, runs its host loop for
`--seconds` (the measured window's trajectory), then from one state S runs
the same `--steps` steps several ways, each resumed from S, so that every
way does the same work:

- under torch.profiler with the tracer off and on, in turns (off, on, on,
  off): the ms a step of each, the device's busy share, and with the
  tracer on the join of the program's layer ranges with the device's
  events (harness/spans.py): busy and idle ms a step by layer, which add up
  to the window;
- with the program's fenced phase timers (`driver.run(timing=True)`): the
  TimingData ms a step by phase, beside the join;
- under torch's sync-debug mode (what `timing.count_syncs` counts) with
  the tracer on: the syncs torch saw against the reads the tracer counted,
  with the source line of each sync;
- `--cost-steps` steps with the tracer off and on, in turns, without a
  profiler: the tracer's own cost.

One JSON object goes to stdout (and to --out).  Needs a CUDA card
(--device cpu with --rs runs the same at a size the CPU takes, for a
rehearsal; its times are the CPU's).
"""

import argparse
import collections
import contextlib
import json
import os
import sys
import time
import warnings

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
for _k, _d in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
               ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(_k, os.path.join(ROOT, ".bench_cache", _d))
sys.path[:0] = [ROOT, BENCH]


def _resume(driver, h, tf, last, dt, steps, **kw):
    step, t, S = last
    return driver.run(h, tf, max_steps=steps, S_init=S, t_init=t,
                      dt_init=dt, step_init=step + 1, **kw)


def _ms_per_step(res, last):
    return 1e3 * res.timings["total"] / (res.steps - last[0])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--cost-steps", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rs", type=int, default=None,
                    help="a smaller mesh (rehearsals on the CPU)")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from harness import profiling, registry, runner, spans
    from laghos_tpu_torch import driver, timing

    dev = torch.device(a.device)
    if dev.type == "cuda":
        from laghos_tpu_torch.ops import kernels

        kernels.build()
    if a.rs is None:
        cell = registry.Cell(registry.benchmark(ROOT), a.workload, ROOT)
    else:
        from tests.benchutil import small_cell

        cell = small_cell(a.workload, a.rs)
    config, traffic = cell.config, cell.traffic
    lo, hi = traffic["blast_energy"]
    E0 = float(np.random.default_rng(a.seed).uniform(lo, hi))
    dtype = {"f64": torch.float64, "f32": torch.float32}[config["dtype"]]
    h = runner.build_hydro(config, traffic, E0, dev, dtype)
    tf = config["t_final"]
    sync = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
            else (lambda: None))

    # the window's trajectory: the host loop for --seconds
    state = {}

    class Stop(Exception):
        pass

    def hook(ti, t, S):
        state["dt"] = t - state["last"][1] if "last" in state else None
        state["last"] = (ti, t, S)
        state.setdefault("t0", time.perf_counter())
        if time.perf_counter() - state["t0"] >= a.seconds:
            raise Stop

    try:
        driver.run(h, tf, vis_steps=1, on_vis=hook)
    except Stop:
        pass
    # resumed at the last accepted step's dt, as the benchmark's traced
    # phases are
    last, dt = state["last"], state["dt"]
    out = {"workload": cell.name, "seed": a.seed, "E0": E0,
           "start_step": last[0], "torch": torch.__version__,
           "device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu")}

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])

    def mark(ti, t, S):
        with torch.profiler.record_function(profiling.MARK):
            pass

    def profiled_off():
        sync()
        with profile(activities=acts) as prof:
            _resume(driver, h, tf, last, dt, a.steps, vis_steps=1,
                    on_vis=mark)
        p = profiling.window(prof)
        return {"ms_per_step": p["window_us"] / 1e3 / p["steps"],
                "busy_pct": 100.0 * p["busy_us"] / p["window_us"]}

    def profiled_on():
        sync()
        j, _ = spans.traced_steps(driver, timing, h, tf, last, dt, a.steps)
        n = j["steps"]
        busy = {k: v / 1e3 / n for k, v in j["busy_us"].items()}
        idle = {k: v / 1e3 / n for k, v in j["idle_us"].items()}
        return {"ms_per_step": j["window_us"] / 1e3 / n,
                "busy_pct": 100.0 * sum(j["busy_us"].values())
                / j["window_us"],
                "busy_ms_per_step": busy, "idle_ms_per_step": idle,
                "sum_ms_per_step": sum(busy.values()) + sum(idle.values()),
                "placed": j["placed"], "reads": j["reads"],
                "reads_in_ranges_per_step": (
                    sum(j["reads"].values()) - j["reads_outside_ranges"])
                / j["accepted"],
                "accepted": j["accepted"], "attempts": j["attempts"]}

    runs = []
    for on in (False, True, True, False):
        runs.append({"tracer": on, **(profiled_on() if on
                                      else profiled_off())})
    out["profiled"] = runs

    sync()
    res = _resume(driver, h, tf, last, dt, a.steps, vis_steps=10 ** 9,
                  timing=True)
    tr = timing.last_trace()
    k = res.steps - last[0]
    out["fenced"] = {
        "ms_per_step": {p: 1e3 * v / k
                        for p, v in res.timing_data.t.items()},
        "accepted": k,
        "reads_in_ranges_per_step": (sum(tr.reads.values())
                                     - tr.reads.get("", 0)) / k}

    if dev.type == "cuda":
        # timing.count_syncs's count, with the source line of each sync
        sites = collections.Counter()
        sync()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with timing.trace() as tr:
                    _resume(driver, h, tf, last, dt, a.steps,
                            vis_steps=10 ** 9)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        for w in seen:
            if "synchroniz" in str(w.message):
                sites[f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"] += 1
        out["syncs"] = {"syncs": sum(sites.values()),
                        "reads": sum(tr.reads.values()),
                        "reads_by_range": dict(tr.reads),
                        "sync_sites": sites.most_common(20),
                        "accepted": tr.accepted()}

    # the tracer's own cost without a profiler, the same steps each way,
    # and of one hook alone
    cost = []
    for on in (False, True, True, False) * 4:
        sync()
        if on:
            with timing.trace():
                res = _resume(driver, h, tf, last, dt, a.cost_steps,
                              vis_steps=1, on_vis=lambda *x: None)
        else:
            res = _resume(driver, h, tf, last, dt, a.cost_steps,
                          vis_steps=1, on_vis=lambda *x: None)
        cost.append((on, _ms_per_step(res, last)))
    out["cost"] = {"off": [v for on, v in cost if not on],
                   "on": [v for on, v in cost if on],
                   "steps": a.cost_steps}
    x = torch.zeros((), device=dev)

    def us_per_call(fn, n):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return 1e6 * (time.perf_counter() - t0) / n

    def one_span():
        with timing.span("laghos.vis"):
            pass

    hooks = {}
    for on in (False, True):
        with timing.trace() if on else contextlib.nullcontext():
            k = "on" if on else "off"
            hooks[f"span_{k}_us"] = us_per_call(one_span, 20000)
            hooks[f"read_{k}_us"] = us_per_call(
                lambda: timing.host_read(x), 2000)
    # the two ways to read a 0-d device value
    hooks["item_us"] = us_per_call(x.item, 2000)
    hooks["tolist_us"] = us_per_call(x.tolist, 2000)
    out["hook_cost"] = hooks
    line = json.dumps(out)
    print(line, flush=True)
    if a.out:
        with open(a.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
