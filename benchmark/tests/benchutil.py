"""Helpers of the benchmark's CPU tests: a cell cut to a size the CPU
runs in seconds, and one run of it through the harness."""

import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import registry, runner  # noqa: E402


def small_cell(name, rs=1):
    """The cell `name` of BENCHMARK.json at refinement `rs` (sizes to
    match)."""
    cell = registry.Cell(registry.benchmark(ROOT), name, ROOT)
    c = dict(cell.config)
    n = 2 * 2 ** rs
    p, pe = c["order_v"], c["order_e"]
    nq1 = (3 * p + pe - 1) // 2 + 1
    c["rs"] = rs
    c["sizes"] = {"elements_per_axis": n, "elements": n ** 3,
                  "h1_dofs": 3 * (n * p + 1) ** 3,
                  "l2_dofs": n ** 3 * (pe + 1) ** 3,
                  "q_points": n ** 3 * nq1 ** 3}
    cell.config = c
    # the check's samples among the first steps, which a short CPU
    # window reaches
    cell.traffic = dict(cell.traffic, sample_span_steps=12)
    return cell


def run_small(name, seed=4123456789012, seconds=1.0, trace=False, rs=1,
              dtype=None):
    return runner.run(small_cell(name, rs), seed, seconds, trace, "cpu",
                      time.perf_counter(), dtype=dtype)
