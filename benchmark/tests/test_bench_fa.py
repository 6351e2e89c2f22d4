"""The full-assembly cell `sedov-q2q1-fa` on the CPU at rs1: the port
agrees with the plain reference under -fa, the control (the program's
float32 path) and a planted fault in the FA velocity solve fail the
check, the SpMV operation counts the assembled mass's nonzeros, a traced
run feeds the cell's readers from the program's counters, and the device
readers read a profile of the SpMV kernels."""

import math

import pytest
import torch

from benchutil import registry, run_small, runner, small_cell

CELL = "sedov-q2q1-fa"


def test_port_agrees_with_the_reference():
    out = run_small(CELL)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


def test_control_fails():
    out = run_small(CELL, dtype=torch.float32)
    assert not out["correct"]
    assert all(v["value"] > v["limit"] for v in out["checks"].values())


def test_spmv_left_out_fails(monkeypatch):
    """The FA velocity solve's operator with the last component's sparse
    product left out and only its diagonal applied (a zero there would
    stop the run: its CG breaks down and dt collapses)."""
    from laghos_tpu_torch.ops import assemble

    real = assemble.csr_apply

    def apply(A, u):
        y = real(A, u)
        y[-1] = A.to_dense().diagonal() * u[-1]
        return y

    monkeypatch.setattr(assemble, "csr_apply", apply)
    out = run_small(CELL)
    assert not out["correct"]
    assert out["failed"] > 0


@pytest.mark.parametrize("rs", [0, 1, 2])
def test_spmv_work_counts_the_assembled_nonzeros(rs):
    cell = small_cell(CELL, rs)
    shape = runner.shape_of(cell.config)
    h = runner.build_hydro(cell.config, cell.traffic, 1.0,
                           torch.device("cpu"), torch.float64)
    op = registry.op("csr_spmv")
    nnz, rows = h._h1_csr._nnz(), h.ndof
    assert op.nonzeros(shape) == nnz and math.prod(
        shape["h1_lattice"]) == rows
    nbytes, nops = op.work(shape)
    assert nbytes == 12 * nnz + 4 * (rows + 1) + 16 * rows and nops is None


def test_traced_run_feeds_the_readers():
    """A traced CPU run reads every metric of the cell that needs no
    device trace: the "laghos.cg_h1" counters of the timed steps give the
    FA solve's iterations a solve, about the PA cell's per-component count
    at the same size, all of them on the eager path (fused share 0)."""
    from laghos_tpu_torch import timing

    out = run_small(CELL, trace=True)
    assert out["correct"]
    m = out["metrics"]
    assert set(m) == {"cg_fa.iters_per_solve", "cg_h1.fused_pct",
                      "cg_h1.ms_per_step", "cg_l2.ms_per_step",
                      "force.ms_per_step", "qdata.ms_per_step",
                      "device.idle_pct", "driver.host_reads_per_step"}
    tr = timing.last_trace()
    key = ("laghos.cg_h1", "generic")
    assert {k for k in tr.cg_solves if k[0] == key[0]} == {key}
    assert m["cg_fa.iters_per_solve"]["value"] == (
        tr.cg_iters[key] / tr.cg_solves[key])
    assert m["cg_h1.fused_pct"]["value"] == 0
    pa = run_small("sedov-q2q1-jacobi", trace=True)["metrics"]
    assert abs(m["cg_fa.iters_per_solve"]["value"]
               - pa["cg_h1.iters_per_solve"]["value"]) <= 2


def test_roofline_reader_on_a_device_profile():
    """The roofline share and the ms a step from a profile of the SpMV
    kernels' device events (named as the card's trace names them): every
    cuSPARSE kernel's time counts, the products are the launches of
    csrmv_v3_kernel, and another kernel's time is not counted."""
    cell = registry.Cell(registry.benchmark(), CELL)
    tr = runner.TraceData(shape=runner.shape_of(cell.config),
                          peaks=registry.peaks(), stages=2)
    nbytes, _ = registry.op("csr_spmv").work(tr.shape)
    least_us = 1e6 * nbytes / tr.peaks["hbm_bytes_per_s"]["value"]
    tr.profile = {"steps": 2, "kernels": {
        "void cusparse::csrmv_v3_kernel<std::integral_constant<bool, "
        "false>, int, int, double, double, double, double, void>": (
            5 * least_us, 3),
        "void cusparse::(anonymous namespace)::csr_partition_kernel<int, "
        "int>": (least_us, 3),
        "void at::native::elementwise_kernel<128, 2>": (1e3, 9)}}
    reader = registry.metric("csr_spmv_roofline")
    assert math.isclose(reader.read(tr), 50.0)
    ms = registry.metric("spmv.ms_per_step")
    assert math.isclose(ms.read(tr), 6 * least_us / 2e3)
    tr.profile = {"steps": 2, "kernels": {}}
    assert reader.read(tr) is None and ms.read(tr) is None
