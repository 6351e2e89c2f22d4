"""Share of the element (L2) mass apply's roofline (ops/elem_mass.py) in
the device time of its kernel in the profiled steps."""

LAYER = "kernel mass.cu"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "fom"


def read(tr):
    return tr.roofline_pct("elem_mass")
