"""The step profiler of the port (`laghos_tpu_torch.profile_steps`) on the
CPU at rs0: every case builds its operator path, steps, and writes one
record for the timed steps and one per profiled window."""

import json
import math

import pytest
import torch

from laghos_tpu_torch import profile_steps

torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(profile_steps.CASES))
def test_profile_case_rs0(name):
    _, ov, oe, opt = profile_steps.CASES[name]
    recs = profile_steps.profile_case(torch.device("cpu"), 0, ov, oe, opt,
                                      warm=1, timed=1, window=1, repeats=2)
    assert len(recs) == 3
    head, windows = recs[0], recs[1:]
    assert (head["lattice"] is not None) == ("lattice" in name)
    assert math.isfinite(head["step_ms"]) and head["step_ms"] > 0
    h1, l2 = head["cg_iters_h1_l2"][0]
    assert h1 > 0 and l2 > 0
    for r, w in enumerate(windows):
        assert w["repeat"] == r and w["wall_ms_per_step"] > 0
        # no device on the CPU: nothing traced as device time
        assert w["busy_ms_per_step"] == 0 and w["device_events_per_step"] == 0


def test_profile_main_writes_lines(tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(profile_steps.CASES, "ns2_lattice_kron",
                        (0, 2, 1, dict(precond="kron")))
    out = tmp_path / "profile.jsonl"
    profile_steps.main(["--cases", "ns2_lattice_kron", "--repeats", "1",
                        "--device", "cpu", "--out", str(out)])
    lines = [json.loads(s) for s in out.read_text().splitlines()]
    assert [ln["case"] for ln in lines] == ["ns2_lattice_kron"] * 2
    assert capsys.readouterr().out.count("ns2_lattice_kron") == 2
