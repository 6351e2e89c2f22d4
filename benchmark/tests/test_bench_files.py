"""Every file of the benchmark loads and keeps to the benchmark's
contract: BENCHMARK.json's keys and limits, the names and units, and one
file a configuration, traffic mix, metric and operation."""

import json
import math
import re

import pytest

from benchutil import BENCH, ROOT, registry

B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(B)) <= 64 * 1024
    assert 1 <= len(B["paths"]) <= 16
    for p in B["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(B["command"]) <= 32 and all(_line(w) for w in B["command"])
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    # a full check of 24 cells (2 + 14 runs a cell of run_seconds + 60 s,
    # 180 s of compilation a cell, 1200 s spare) fits in 43,200 s
    assert (2 + 14 * 24) * (B["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_entries(section):
    entries = B[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert set(e) - {"workloads"} == ENTRY_KEYS[section], e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")


def test_configs():
    used = {w["config"] for w in B["workloads"]}
    files = set()
    for c in B["configs"]:
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        cfg = registry.load_json(ROOT / c["file"])
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) <= set(cfg["reduced"]) and len(
            c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) or k.startswith("order")
                       for k in c["reduced"])
        s = cfg["sizes"]
        n, p, pe = s["elements_per_axis"], cfg["order_v"], cfg["order_e"]
        nq1 = (3 * p + pe - 1) // 2 + 1
        assert n == 2 * 2 ** cfg["rs"] and s["elements"] == n ** 3
        assert s["h1_dofs"] == 3 * (n * p + 1) ** 3
        assert s["l2_dofs"] == n ** 3 * (pe + 1) ** 3
        assert s["q_points"] == n ** 3 * nq1 ** 3
        assert set(cfg["limits"]) == {"start", "step_x", "step_v", "step_e"}
        # RK2Avg (-s 7), the solver both configurations state, evaluates
        # the right-hand side twice a step
        assert cfg["ode_solver"] != 7 or cfg["rhs_per_step"] == 2
        registry.reference(cfg["reference"])
    assert len({c["source"] for c in B["configs"]}) == len(B["configs"])


def test_workloads():
    four = [w for w in B["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(B["workloads"]) // 4)
    pairs = {(w["config"], w["traffic"]) for w in B["workloads"]}
    assert len(pairs) == len(B["workloads"])
    for w in B["workloads"]:
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        t = registry.traffic(w["traffic"])
        lo, hi = t["blast_energy"]
        assert 0 < lo < hi and t["warmup_steps"] >= 2 and t["samples"] >= 1
        assert t["sample_span_steps"] >= 4
        cell = registry.Cell(B, w["name"], ROOT)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer


def test_end_to_end():
    names = {m["name"] for m in B["end_to_end"]}
    assert {"fom", "step_ms_p90", "peak_mem_gib", "setup_s"} == names
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("entry", B["per_layer"], ids=lambda e: e["name"])
def test_per_layer(entry):
    mod = registry.metric(entry["name"])
    assert (mod.LAYER, mod.UNIT, mod.BETTER, mod.SOURCE, mod.MOVES) == (
        entry["layer"], entry["unit"], entry["better"], entry["source"],
        entry["moves"])
    assert _line(entry["layer"]) and entry["source"] in (
        "device_trace", "program_span", "program_counter", "host_clock")
    assert entry["moves"] in {m["name"] for m in B["end_to_end"]}
    cells = {w["name"] for w in B["workloads"]}
    assert set(entry["workloads"]) <= cells
    if entry["name"].endswith("_roofline"):
        assert entry["unit"] == "%"


def test_files_under_paths_are_named_from_names():
    for f in BENCH.rglob("*"):
        if "__pycache__" in f.parts or f.is_dir():
            continue
        rel = f.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel


@pytest.mark.parametrize("name", ["lattice_mass", "elem_mass", "qphys"])
def test_ops_load(name):
    op = registry.op(name)
    assert op.KERNELS and any(op.CALL in k or k in op.CALL
                              for k in op.KERNELS)
    shape = {"dim": 3, "order_v": 2, "order_e": 1, "nq1": 4,
             "elements": 8, "h1_lattice": [5] * 3, "q_lattice": [8] * 3,
             "dtype_bytes": 8, "dtype": "f64"}
    nbytes, nops = op.work(shape)
    assert nbytes > 0 and (nops is None or nops > 0)


def test_peaks():
    pk = registry.peaks()
    assert math.isclose(pk["hbm_bytes_per_s"]["value"], 3.35e12)
    assert set(pk["flops_per_s"]) == {"f64", "f32"}
    for v in pk["flops_per_s"].values():
        assert v["value"] > 0 and v["source"]
