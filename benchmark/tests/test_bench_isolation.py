"""What a run loads and where it runs: no JAX and no JAX package in a run
(names compared whole: the port's name begins with the JAX package's),
nothing of the port in the reference, and no result without a card or
without the program beside the benchmark."""

import json
import shutil
import subprocess
import sys

from benchutil import BENCH, ROOT


def _py(code, cwd=ROOT):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=600)


def test_a_run_loads_no_jax():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import run, benchutil\n"
        "out = benchutil.run_small('sedov-q2q1-jacobi')\n"
        "mods = {m.split('.')[0] for m in sys.modules}\n"
        "print(run.forbidden_modules(), 'laghos_tpu_torch' in mods,"
        " out['correct'])\n" % (str(BENCH), str(BENCH / "tests")))
    r = _py(code)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split("\n")[-2] == "[] True True"


def test_the_reference_imports_nothing_of_the_program():
    code = (
        "import sys; sys.path[:0] = [%r]\n"
        "from harness import registry\n"
        "for name in ('sedov3d',):\n"
        "    ref = registry.reference(name)\n"
        "    p = ref.Sedov3D(elements_per_axis=2, order_v=2, order_e=1,"
        " cfl=0.5, blast_energy=1.0)\n"
        "    p.step(p.initial_state(), 1e-4)\n"
        "print(sorted(m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'laghos_tpu', 'laghos_tpu_torch')))"
        % str(BENCH))
    r = _py(code)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip() == "[]"
    for f in (BENCH / "reference").glob("*.py"):
        src = f.read_text()
        assert "laghos_tpu" not in src.replace("laghos_tpu_torch", "") \
            and "import laghos" not in src and "from laghos" not in src


def _command(cwd):
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    return subprocess.run(
        [sys.executable, *b["command"][1:], "--workload",
         b["workloads"][0]["name"], "--seed", "4294967311", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=600)


def test_no_card_no_result():
    r = _command(ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_no_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _command(tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""
