"""The check holds: the plain reference agrees with the port on the CPU at
small sizes, and every fault a cell can have, and the control (the
program's own float32 path), make `correct` come out false.  Each run
drives the whole harness (set-up, the window through the host loop, the
check) on the CPU; the faults are planted under the timed path in
`Hydro.advance`."""

import pytest
import torch

from benchutil import run_small

CELLS = ["sedov-q2q1-jacobi", "sedov-q4q3-jacobi"]
RS = {"sedov-q4q3-jacobi": 0}


@pytest.mark.parametrize("name", CELLS)
def test_port_agrees_with_the_reference(name):
    out = run_small(name, rs=RS.get(name, 1))
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    """The program's float32 path in place of the configuration's f64."""
    out = run_small(name, rs=RS.get(name, 1), dtype=torch.float32)
    assert not out["correct"]
    assert all(v["value"] > v["limit"] for v in out["checks"].values())


def _unchanged(S, new):
    return S


def _half_left_out(S, new):
    """Half of the elements and nodes keep their old values: the update
    computed on the rest only."""
    out = {k: v.clone() for k, v in new.items()}
    out["e"][1::2] = S["e"][1::2]
    out["v"][:, 1::2] = S["v"][:, 1::2]
    return out


def _altered(S, new):
    """One velocity value changed where the step produces it."""
    out = {k: v.clone() for k, v in new.items()}
    k = int((new["v"] - S["v"]).abs().reshape(-1).argmax())
    out["v"].view(-1)[k] += 1e-6 * float(new["v"].abs().max())
    return out


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _altered],
                         ids=["state-unchanged", "half-left-out",
                              "answer-altered"])
def test_fault_fails(monkeypatch, fault):
    from laghos_tpu_torch.hydro import Hydro

    real = Hydro.advance

    def advance(self, S, dt, count_stage1=False, sJit1=None):
        new, est, stats, sj = real(self, S, dt, count_stage1, sJit1)
        return fault(S, new), est, stats, sj

    monkeypatch.setattr(Hydro, "advance", advance)
    out = run_small("sedov-q2q1-jacobi")
    assert not out["correct"]
    assert out["failed"] > 0


def test_traced_run_reports_its_readers():
    out = run_small("sedov-q2q1-jacobi", trace=True)
    assert out["correct"]
    m = out["metrics"]
    # the CPU has no device trace and no sync counter: those readers
    # return nothing and stay out of the line
    for name in ("cg_h1.ms_per_step", "cg_l2.ms_per_step",
                 "force.ms_per_step", "qdata.ms_per_step"):
        assert m[name]["value"] > 0 and m[name]["unit"] == "ms"
    assert m["cg_h1.iters_per_solve"]["value"] > 1
    assert m["cg_l2.iters_per_solve"]["value"] >= 1
    for name in ("lattice_mass_roofline", "elem_mass_roofline",
                 "qphys_roofline", "driver.syncs_per_step"):
        assert name not in m
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["device"]["window_s"] > 0
