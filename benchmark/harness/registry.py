"""Find the benchmark's data by name: BENCHMARK.json at the checkout's
root, and beside this package the configurations (`configs/`), the
traffic mixes (`traffic/`), the per-layer metric readers (`metrics/`), the
kernels' work from shapes (`ops/`), the plain references (`reference/`)
and the peaks (`peaks.json`).  Adding a cell, a configuration, a metric or
an operation is adding files and entries: nothing here names one."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return load_json(Path(root) / "BENCHMARK.json")


def _module(kind, name):
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {name!r} in {kind}/ ({path})")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric(name):
    """The reader of the per-layer metric `name`: LAYER, UNIT, BETTER,
    SOURCE, MOVES and read(trace) -> number or None."""
    return _module("metrics", name)


def op(name):
    """An operation's kernels and work: KERNELS (device-side names),
    CALL (the name launched once an apply) and work(shape) ->
    (bytes, operations or None)."""
    return _module("ops", name)


def reference(name):
    return _module("reference", name)


def traffic(name):
    return load_json(BENCH_DIR / "traffic" / f"{name}.json")


def peaks():
    return load_json(BENCH_DIR / "peaks.json")


class Cell:
    """One entry of BENCHMARK.json's workloads with its configuration,
    traffic and the metrics it reports."""

    def __init__(self, bench, name, root=ROOT):
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload named {name!r}; "
                           f"known: {sorted(by_name)}")
        w = by_name[name]
        cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
        self.name = name
        self.chips = int(w["chips"])
        self.config_name = w["config"]
        self.config = load_json(Path(root) / cfg["file"])
        self.traffic_name = w["traffic"]
        self.traffic = traffic(w["traffic"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]
