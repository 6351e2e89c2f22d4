"""Share of the lattice H1 mass apply's roofline (ops/lattice_mass.py) in
the device time of its kernels in the profiled steps."""

LAYER = "kernel lattice_mass.cu"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "fom"


def read(tr):
    return tr.roofline_pct("lattice_mass")
