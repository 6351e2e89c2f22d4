"""The operations' work from shapes reproduces the bounds of PERF.md's
kernel tables (chip_smoke.py's counts at the flagship and Q8-Q7 shapes):
the same bytes and operations, and the same roofs (3.35 TB/s; 67 TFLOP/s
in f64 and f32, the rate chip_smoke.py's mass kernels are bound at), so
the bound ms agree to the printed digits.  The q-point physics is bound
by its bytes alone in both (its operation count is an estimate that
chip_smoke.py keeps beside the bound and this benchmark leaves out)."""

import pytest

from benchutil import registry

PEAKS = registry.peaks()


def bound_ms(op, shape):
    nbytes, nops = registry.op(op).work(shape)
    t = nbytes / PEAKS["hbm_bytes_per_s"]["value"]
    by = "bytes"
    if nops is not None:
        t_ops = nops / PEAKS["flops_per_s"][shape["dtype"]]["value"]
        if t_ops > t:
            t, by = t_ops, "operations"
    return 1e3 * t, by


def shape(n, p, pe, dtype):
    nq1 = (3 * p + pe - 1) // 2 + 1
    return {"dim": 3, "order_v": p, "order_e": pe, "nq1": nq1,
            "elements": n ** 3, "h1_lattice": [n * p + 1] * 3,
            "q_lattice": [n * nq1] * 3,
            "dtype_bytes": {"f64": 8, "f32": 4}[dtype], "dtype": dtype}


# (op, elements an axis, orders, dtype) -> PERF.md's bound ms and its kind
CASES = [
    ("lattice_mass", 32, 2, 1, "f64", 0.0089, "bytes"),     # flagship
    ("lattice_mass", 32, 2, 1, "f32", 0.0045, "bytes"),
    ("lattice_mass", 16, 8, 7, "f64", 0.0708, "bytes"),     # q8
    ("lattice_mass", 16, 8, 7, "f32", 0.0483, "operations"),
    ("elem_mass", 32, 2, 1, "f64", 0.0063, "bytes"),        # flagship L2
    ("elem_mass", 32, 2, 1, "f32", 0.0031, "bytes"),
    ("elem_mass", 16, 8, 7, "f64", 0.0501, "bytes"),        # q8 L2
    ("elem_mass", 16, 8, 7, "f32", 0.0250, "bytes"),
    ("qphys", 32, 2, 1, "f64", 0.2053, "bytes"),            # q-lattice
    ("qphys", 32, 2, 1, "f32", 0.1027, "bytes"),
    ("qphys", 16, 8, 7, "f64", 1.6427, "bytes"),
    ("qphys", 16, 8, 7, "f32", 0.8213, "bytes"),
]


@pytest.mark.parametrize("op,n,p,pe,dtype,ms,by", CASES,
                         ids=[f"{c[0]}-{c[2]}-{c[4]}" for c in CASES])
def test_bound_matches_perf_table(op, n, p, pe, dtype, ms, by):
    got, got_by = bound_ms(op, shape(n, p, pe, dtype))
    assert got_by == by
    assert round(got, 4) == pytest.approx(ms, abs=1e-4)


def test_lattice_mass_least_operations():
    # chip_smoke.lattice_mass_ops's least work at q8: 3.235e9 operations
    _, nops = registry.op("lattice_mass").work(shape(16, 8, 7, "f64"))
    assert round(nops / 1e9, 3) == 3.235
