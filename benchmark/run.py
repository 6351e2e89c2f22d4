"""The benchmark of laghos_tpu_torch: one run of one cell on the card.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  The cell (BENCHMARK.json's workloads)
names a configuration (benchmark/configs/) and a traffic mix
(benchmark/traffic/); the seed draws the blast energy and the steps the
check samples.  Set-up builds the configuration's `Hydro` and takes the
traffic's warm-up steps; the window then runs the host loop for S seconds
(--trace 0 reports the end-to-end metrics), or for S seconds followed by
the traced phases (--trace 1 reports the per-layer metrics).  The last
line of stdout is the result as one JSON object; the numbers the check
compared, each beside its limit, are the last lines of stderr.

A run needs a CUDA card (it never falls back to the CPU), loads neither
JAX nor the JAX package, and keeps the program's kernel build in
laghos_tpu_torch/build/ and any torch or Triton cache under .bench_cache/
inside the checkout.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
for _k, _d in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
               ("TRITON_CACHE_DIR", "triton")):
    os.environ[_k] = os.path.join(ROOT, ".bench_cache", _d)
sys.path[:0] = [ROOT, BENCH]

# top-level module names a run may not load (the JAX package's name is a
# prefix of the port's, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "laghos_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import torch

    from harness import registry, runner

    cell = registry.Cell(registry.benchmark(ROOT), a.workload, ROOT)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark does not run on the CPU",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    out = runner.run(cell, a.seed, a.seconds, bool(a.trace), "cuda", T0)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
