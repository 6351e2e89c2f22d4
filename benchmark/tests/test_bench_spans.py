"""The join of the program's layer ranges with the device's events
(`harness/spans.py`) on stub events with a known answer, the traced steps
on the CPU, and the host-read counter in a traced CPU run of a cell."""

from types import SimpleNamespace

import pytest
import torch

from benchutil import run_small, small_cell
from harness import profiling, runner, spans

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


def _ev(name, s, t, dev=CPU, id=0):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(
        start=s, end=t), device_type=dev, id=id)


def _steps(*ranges):
    """Marks at 0 and 100 around a step [0, 100] holding `ranges`."""
    return [_ev(profiling.MARK, 0, 0), _ev(profiling.MARK, 100, 100),
            _ev("laghos.step", 0, 100), *ranges]


def _check(out, busy, idle):
    assert out["busy_us"] == pytest.approx(
        {k: busy.get(k, 0.0) for k in spans.LAYERS})
    assert out["idle_us"] == pytest.approx(
        {k: idle.get(k, 0.0) for k in spans.LAYERS})
    total = sum(out["busy_us"].values()) + sum(out["idle_us"].values())
    assert total == pytest.approx(out["window_us"])


def test_known_answer():
    """Kernels go to the range that launched them, wherever they run; a
    gap spanning the driver's time and the velocity CG's is split by
    overlap."""
    ev = _steps(
        _ev("laghos.qdata", 10, 30), _ev("laghos.cg_h1", 40, 80),
        _ev("cudaLaunchKernel", 15, 16, id=7),
        _ev("cudaLaunchKernel", 45, 46, id=8),
        _ev("cudaMemcpyAsync", 85, 86, id=9),
        _ev("k_qdata", 20, 35, CUDA, 7), _ev("k_cg", 50, 60, CUDA, 8),
        _ev("Memcpy DtoH", 86, 90, CUDA, 9),
        _ev("aten::mul", 44, 47, id=8),
        # the profiler's copy of a range on the device's timeline
        _ev("laghos.cg_h1", 50, 60, CUDA, 0))
    out = spans.window(ev)
    assert out["steps"] == 1 and out["window_us"] == 100
    assert out["placed"] == {"correlation": 3, "order": 0, "none": 0,
                             "unmatched": []}
    # idle: [0, 20] is 10 of the step's own time, 10 of q-data's;
    # [35, 50] 5 of the driver's, 10 of CG-H1's; [60, 86] 20 and 6;
    # [90, 100] the driver's
    _check(out, busy={"qdata": 15, "cg_h1": 10, "driver": 4},
           idle={"driver": 10 + 5 + 6 + 10, "qdata": 10, "cg_h1": 10 + 20})


def test_uncorrelated_kernel_placed_by_order():
    """A hand kernel launched through ctypes whose device event matches no
    launch's id: the k-th unmatched kernel is the k-th unmatched launch."""
    ev = _steps(
        _ev("laghos.force", 10, 30), _ev("laghos.cg_l2", 40, 70),
        _ev("cudaLaunchKernel", 12, 13, id=0),
        _ev("cudaLaunchKernel", 41, 42, id=5),
        _ev("cudaLaunchKernel", 45, 46, id=0),
        _ev("mass_kernel", 20, 50, CUDA, 101),
        _ev("k", 50, 55, CUDA, 5),
        _ev("mass_kernel", 60, 65, CUDA, 102))
    out = spans.window(ev)
    assert out["placed"] == {"correlation": 1, "order": 2, "none": 0,
                             "unmatched": [("mass_kernel", 2)]}
    _check(out, busy={"force": 30, "cg_l2": 5 + 5},
           idle={"driver": 10 + 30, "force": 10, "cg_l2": 5 + 5})


def test_overlap_counts_once_and_clips_to_the_marks():
    """Overlapping device intervals count once, for the first to start;
    what runs before the first or after the last mark is left out."""
    ev = _steps(
        _ev("laghos.cg_h1", 5, 95),
        _ev("cudaLaunchKernel", -20, -19, id=1),
        _ev("cudaLaunchKernel", 6, 7, id=2),
        _ev("cudaLaunchKernel", 8, 9, id=3),
        _ev("early", -10, 10, CUDA, 1), _ev("a", 20, 60, CUDA, 2),
        _ev("b", 40, 120, CUDA, 3))
    out = spans.window(ev)
    _check(out, busy={"driver": 10, "cg_h1": 40 + 40},
           idle={"cg_h1": 10})


def test_a_kernel_without_a_launch_is_the_drivers():
    ev = _steps(_ev("laghos.cg_h1", 5, 95), _ev("k", 20, 30, CUDA, 4),
                _ev("k", 30, 40, CUDA, 0))
    out = spans.window(ev)
    assert out["placed"]["none"] == 2
    _check(out, busy={"driver": 20},
           idle={"driver": 10, "cg_h1": 70})


def test_nested_ranges_take_the_innermost():
    segs = spans.segments([(0, 100, "laghos.step"), (10, 50, "laghos.vis"),
                           (20, 30, "laghos.cg_l2"), (60, 70,
                                                      "laghos.force")],
                          0, 100)
    assert segs == [(0, 20, "driver"), (20, 30, "cg_l2"),
                    (30, 60, "driver"), (60, 70, "force"),
                    (70, 100, "driver")]


def test_traced_steps_on_the_cpu():
    """The traced steps of a cell at rs1 on the CPU: no device event, so
    the window is idle and split over the layers, and the program's
    counter reads every step's CG flags."""
    from laghos_tpu_torch import driver, timing

    cell = small_cell("sedov-q2q1-jacobi")
    h = runner.build_hydro(cell.config, cell.traffic, 1.0,
                           torch.device("cpu"), torch.float64)
    r = driver.run(h, 0.6, max_steps=2)
    out, (last, dt) = spans.traced_steps(
        driver, timing, h, 0.6, (r.steps, r.t, r.S), r.dt, 3)
    # max_steps 3 runs 4 attempts (the reference's -ms): 4 marks, and
    # the 3 whole steps between them
    assert out["steps"] == 3 and last[0] == r.steps + 4
    assert sum(out["busy_us"].values()) == 0
    idle = out["idle_us"]
    assert sum(idle.values()) == pytest.approx(out["window_us"])
    assert idle["cg_h1"] > 0 and idle["qdata"] > 0 and idle["force"] > 0
    assert out["reads"]["cg_h1"] > out["reads"]["cg_l2"] > 0
    assert out["accepted"] == out["attempts"] == 4


def test_traced_run_counts_host_reads():
    out = run_small("sedov-q2q1-jacobi", trace=True)
    m = out["metrics"]["driver.host_reads_per_step"]
    assert m["value"] > 0 and m["unit"] == "reads/step"
