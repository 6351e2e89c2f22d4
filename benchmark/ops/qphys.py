"""The q-point physics of the lattice q-update
(`ops/qphys.physics_3d_lattice`, on the card `csrc/qphys.cu`): its bytes
from its shapes.

Bytes: the operation's inputs read once (J, the reference velocity
gradient and the t = 0 inverse Jacobian, 9 fields each; the energy,
rho0 detJ0 w, gamma and 1/w) and its outputs written once (the 9 stress
fields and the dt estimate), each one value a q-point: 41 values a point,
chip_smoke.py's count (`_nbytes(args) + _nbytes(out_k)`, :658).  Operations
are not counted: the repo has only an estimate of them (1000 a point,
chip_smoke.py:292-295), which is not a least count, so the bound is the
bytes alone (at that estimate the operations take a seventh of the
byte time)."""

import math

KERNELS = ("qphys_kernel",)
CALL = "qphys_kernel"
VALUES_PER_POINT = 9 + 9 + 9 + 4 + 9 + 1


def work(shape):
    """(bytes, None) of one call over every q-point."""
    points = math.prod(shape["q_lattice"])
    return VALUES_PER_POINT * points * shape["dtype_bytes"], None
