"""The step profiler of the port (`laghos_tpu_torch.profile_steps`) on the
CPU at rs0: every case builds its operator path, steps, and writes one
record for the timed steps and one per profiled window."""

import json
import math
from types import SimpleNamespace

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
        assert set(w["hand_kernels"]) == set(profile_steps.HAND_KERNELS)
        assert all(v == dict(ms_per_step=0.0, launches_per_step=0.0)
                   for v in w["hand_kernels"].values())


def test_profile_main_writes_lines(tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(profile_steps.CASES, "ns2_lattice_kron",
                        (0, 2, 1, dict(precond="kron")))
    out = tmp_path / "profile.jsonl"
    profile_steps.main(["--cases", "ns2_lattice_kron", "--repeats", "1",
                        "--device", "cpu", "--out", str(out)])
    lines = [json.loads(s) for s in out.read_text().splitlines()]
    assert [ln["case"] for ln in lines] == ["ns2_lattice_kron"] * 2
    assert capsys.readouterr().out.count("ns2_lattice_kron") == 2


def test_hand_kernel_times_from_stub_events():
    """Device time and launches per step of the hand-written kernels, by
    device-side name; host events and other kernels are not counted."""
    cuda, cpu = (torch.autograd.DeviceType.CUDA,
                 torch.autograd.DeviceType.CPU)

    def ev(name, start, end, dev=cuda):
        return SimpleNamespace(name=name, device_type=dev,
                               time_range=SimpleNamespace(start=start,
                                                          end=end))

    events = [
        ev("void (anonymous namespace)::split_kernel<8>(double const*)",
           0.0, 30.0),
        ev("void (anonymous namespace)::split_kernel<6>(double const*)",
           40.0, 50.0),
        ev("void (anonymous namespace)::qphys_kernel<double, 1, true, "
           "false>(Args<double>)", 100.0, 400.0),
        ev("void (anonymous namespace)::mass_kernel<double, 3, 8, 16>("
           "double const*)", 600.0, 700.0),
        ev("void (anonymous namespace)::mass_kernel_rt<float>(float const*)",
           700.0, 800.0),
        ev("split_kernel", 0.0, 1000.0, dev=cpu),        # host side
        ev("sm80_xmma_gemm_f64f64", 500.0, 900.0),       # another kernel
    ]
    got = profile_steps.hand_kernel_times(events, steps=2)
    assert got["split_kernel"] == dict(ms_per_step=0.02,
                                       launches_per_step=1.0)
    assert got["qphys_kernel"] == dict(ms_per_step=0.15,
                                       launches_per_step=0.5)
    assert got["mass_kernel"] == dict(ms_per_step=0.1,
                                      launches_per_step=1.0)


def test_hand_kernel_times_tell_the_mass_kernels_apart():
    """The lattice mass kernel's two device kernels (its element stages,
    compiled or runtime-size, and its assembly) count under their own
    names and not under the element mass kernel's."""
    cuda = torch.autograd.DeviceType.CUDA

    def ev(name, start, end):
        return SimpleNamespace(name=name, device_type=cuda,
                               time_range=SimpleNamespace(start=start,
                                                          end=end))

    events = [
        ev("void (anonymous namespace)::lattice_mass_stages<double, 3, 9, "
           "16>((anonymous namespace)::LatSrc<double>)", 0.0, 200.0),
        ev("void (anonymous namespace)::lattice_mass_stages_rt<float>("
           "(anonymous namespace)::LatSrc<float>)", 200.0, 300.0),
        ev("void (anonymous namespace)::lattice_mass_assemble<double>("
           "double const*)", 300.0, 340.0),
        ev("void (anonymous namespace)::mass_kernel<double, 3, 9, 16>("
           "double const*)", 400.0, 500.0),
    ]
    got = profile_steps.hand_kernel_times(events, steps=1)
    assert got["lattice_mass_stages"] == dict(ms_per_step=0.3,
                                              launches_per_step=2.0)
    assert got["lattice_mass_assemble"] == dict(ms_per_step=0.04,
                                                launches_per_step=1.0)
    assert got["mass_kernel"] == dict(ms_per_step=0.1, launches_per_step=1.0)
    assert not any(a != b and a in b for a in profile_steps.HAND_KERNELS
                   for b in profile_steps.HAND_KERNELS)
