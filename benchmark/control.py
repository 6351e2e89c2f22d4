"""Readings of the check's numbers on many seeds in one process, for the
limits in the configuration files.

    python3 benchmark/control.py --workload NAME --seconds S \
        --dtype f32|f64 --seeds N [N ...]

Each seed is a whole run of the cell (set-up, a window of S seconds, the
check) at the cell's own size on the card.  With --dtype f32 the program
runs its own float32 path, the nearest precision below the f64 that the
configurations state: the control, which has to fail the check.  With
--dtype f64 it gives the program's own readings.  One JSON line a seed,
then the largest and smallest reading of each number.  The benchmark's
runs (run.py) never run this.
"""

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [ROOT, BENCH]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--dtype", choices=("f32", "f64"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)

    import torch

    from harness import check, registry, runner

    cell = registry.Cell(registry.benchmark(ROOT), a.workload, ROOT)
    dtype = {"f32": torch.float32, "f64": torch.float64}[a.dtype]
    seen = {k: [] for k in check.NUMBERS}
    for seed in a.seeds:
        out = runner.run(cell, seed, a.seconds, False, "cuda",
                         time.perf_counter(), dtype=dtype)
        vals = {k: v["value"] for k, v in out["checks"].items()}
        for k in seen:
            seen[k].append(vals[k])
        print(json.dumps({"workload": a.workload, "dtype": a.dtype,
                          "seed": seed, "correct": out["correct"],
                          "steps": out["attempted"], **vals}), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": a.workload, "dtype": a.dtype,
                      "seeds": len(a.seeds),
                      "max": {k: max(v) for k, v in seen.items()},
                      "min": {k: min(v) for k, v in seen.items()}}))


if __name__ == "__main__":
    main()
