"""Share of the assembled velocity mass product's byte bound
(ops/csr_spmv.py) in the device time of cuSPARSE's SpMV kernels in the
profiled steps."""

LAYER = "kernel cuSPARSE SpMV"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "fom"


def read(tr):
    return tr.roofline_pct("csr_spmv")
