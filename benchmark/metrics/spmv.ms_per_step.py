"""The full-assembly velocity solve's sparse products (ops/assemble.
csr_apply inside Hydro._cg_velocity_fa, each a cuSPARSE SpMV) ms an
accepted step: the device time of the kernels of ops/csr_spmv.py in the
profiled steps over their number.  None where none ran."""

LAYER = "CG-FA"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "fom"
OP = "csr_spmv"


def read(tr):
    p = tr.profile
    if p is None or not p.get("steps"):
        return None
    from harness import registry

    kernels = registry.op(OP).KERNELS
    us = sum(t for name, (t, _) in p["kernels"].items()
             if any(k in name for k in kernels))
    return 1e-3 * us / p["steps"] if us > 0 else None
