"""Share of the q-point physics' byte bound (ops/qphys.py) in the device
time of its kernel in the profiled steps."""

LAYER = "kernel qphys.cu"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "fom"


def read(tr):
    return tr.roofline_pct("qphys")
