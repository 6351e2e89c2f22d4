"""The CLI's distribution flags on gloo CPU ranks: `-nd N` with and
without --halo, --pencil, -sfc, -rp and -epm run and print the step lines
of the one-device run (|e| at 1e-11); the outputs see the global state
(--checkpoint, -visit) and a replicated run resumes from a checkpoint;
every refusal (-amr with -nd naming A11b, --restore with --halo, bad
partitions, nccl on CPU ranks, -fa and simplex meshes with -nd, --mxu)
raises before any rank starts."""

import os
import re

import numpy as np
import pytest
import torch

from laghos_tpu_torch import cli

torch.set_num_threads(1)

BASE = ["-d", "cpu", "-p", "1", "-dim", "3", "-rs", "1", "-ms", "3"]
LINE = re.compile(r"step\s+(\d+),\s+t = (\S+),\s+dt = (\S+),\s+\|e\| = (\S+)")


def _lines(text):
    return [m.groups() for m in LINE.finditer(text)]


def _single(argv, capsys):
    capsys.readouterr()
    run = cli.main(argv)
    return run, _lines(capsys.readouterr().out)


def _same_lines(got, ref):
    assert len(got) == len(ref) > 0
    for (s, t, dt, e), (s2, t2, dt2, e2) in zip(got, ref):
        assert (s, t, dt) == (s2, t2, dt2)
        assert abs(float(e) - float(e2)) <= 1e-11 * abs(float(e2))


@pytest.mark.parametrize("extra,ref_extra", [
    (["-nd", "4", "--halo"], []),
    (["-nd", "4"], []),
    (["-nd", "4", "--halo", "--pencil", "2x2"], []),
    (["-nd", "2", "--halo", "-sfc", "-m", "square01_quad", "-dim", "2"],
     ["-m", "square01_quad", "-dim", "2"]),
    (["-nd", "2", "--halo", "-rs", "0", "-rp", "1"], ["-rs", "1"]),
], ids=["halo", "replicated", "pencil", "sfc", "rp"])
def test_cli_nd_prints_the_single_device_lines(extra, ref_extra, capsys):
    run = cli.main(BASE + extra)
    ref, ref_lines = _single(BASE + ref_extra, capsys)
    _same_lines(_lines(run.log), ref_lines)
    assert run.hydro is None and len(run.ranks) == int(extra[1])
    assert run.result.steps == ref.result.steps
    # the global state, to the CGs' stopping tolerance (-cgt 1e-8)
    for k in ("x", "v", "e"):
        G, R = run.result.S[k], ref.result.S[k]
        assert G.shape == R.shape
        assert float((G - R).abs().max()) <= 1e-9 * float(R.abs().max())
    assert "Energy  diff:" in run.log


def test_cli_epm_runs_on_ranks():
    run = cli.main(BASE + ["-nd", "2", "--halo", "-epm", "8"])
    assert "Number of zones in the serial mesh: 16" in run.log
    assert [r["NE"] for r in run.ranks] == [8, 8]
    assert np.isfinite(run.result.e_norm)


def test_cli_nd_outputs_and_restore(tmp_path, capsys):
    """--checkpoint and -visit over ranks write the global state; a
    replicated run resumes from the checkpoint as the one-device run
    does."""
    base = ["-d", "cpu", "-p", "1", "-dim", "2", "-rs", "2", "-vs", "2"]
    ck1, ck2 = tmp_path / "one.npz", tmp_path / "two.npz"
    _single(base + ["-ms", "3", "--checkpoint", str(ck1)], capsys)
    run = cli.main(base + ["-ms", "3", "-nd", "2", "--halo", "--checkpoint",
                           str(ck2), "-visit", "-k",
                           str(tmp_path / "out" / "Laghos")])
    a, b = np.load(ck1), np.load(ck2)
    assert int(a["step"]) == int(b["step"]) and float(a["t"]) == float(b["t"])
    for k in ("x", "v", "e"):
        assert np.abs(a[k] - b[k]).max() <= 1e-11 * np.abs(a[k]).max()
    written = os.listdir(tmp_path / "out")
    assert any(f.endswith(".pvd") for f in written), written
    ref, ref_lines = _single(base + ["-ms", "6", "--restore", str(ck1)],
                             capsys)
    res = cli.main(base + ["-ms", "6", "-nd", "2", "--restore", str(ck1)])
    _same_lines(_lines(res.log), ref_lines)
    assert run.result.steps < res.result.steps == ref.result.steps


@pytest.mark.parametrize("argv,exc,match", [
    (["-amr", "-nd", "2"], NotImplementedError, "A11b"),
    (["-nd", "2", "--halo", "--restore", "x.npz"], SystemExit, "--halo"),
    (["-nd", "3", "--halo"], ValueError, "divisible"),
    (["-nd", "3", "--halo", "--pencil", "2x2"], ValueError, "needs 4 ranks"),
    (["-nd", "2", "--pencil", "2x1"], ValueError, "needs --halo"),
    (["-nd", "2", "--dist-backend", "nccl"], ValueError, "gloo"),
    (["-nd", "2", "-fa"], ValueError, "partial-assembly"),
    (["-nd", "2", "-m", "cube01_tet"], ValueError, "simplex"),
    (["-nd", "2", "-d", "cuda"], RuntimeError, "CUDA"),
    (["--mxu", "bf16"], NotImplementedError, "Not to port"),
], ids=["amr", "restore_halo", "slab_partition", "pencil_ranks",
        "pencil_without_halo", "nccl_on_cpu", "fa", "simplex", "cuda",
        "mxu"])
def test_cli_refusals(argv, exc, match):
    if argv[-1] == "cuda" and torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(exc, match=match):
        cli.main(BASE + argv)
