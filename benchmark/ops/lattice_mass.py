"""The lattice H1 PA mass apply (`ops/lattice.mass_apply_lattice`, the
velocity CG's operator, on the card `csrc/lattice_mass.cu`): its least
work from its shapes, whatever the route.

Bytes: the input u (C components on the H1 lattice) and the q-lattice
weights read once, the output y written once.  Operations: the banded sum
factorization y = T' D T u, one axis at a time, nd1 multiply-adds (two
operations) for each q-point of each contraction, in the axis order with
the fewest, forward and transposed, and one multiply by D a q-point
(`lattice_mass_ops`, chip_smoke.py:926-946)."""

import itertools
import math

# device-side names of its two launches an apply (the element stages,
# compiled or runtime-size, and the assembly); the assembly runs once an
# apply
KERNELS = ("lattice_mass_stages", "lattice_mass_assemble")
CALL = "lattice_mass_assemble"


def lattice_mass_ops(lat, qlat, nd1, C):
    def contracted(order):
        shape, n = list(lat), 0
        for k in order:
            shape[k] = qlat[k]
            n += math.prod(shape)
        return n

    least = min(contracted(o)
                for o in itertools.permutations(range(len(lat))))
    return C * (2 * 2 * nd1 * least + math.prod(qlat))


def work(shape):
    """(bytes, operations) of one apply to all dim velocity components."""
    lat, qlat, C = shape["h1_lattice"], shape["q_lattice"], shape["dim"]
    nbytes = (2 * C * math.prod(lat) + math.prod(qlat)) * shape["dtype_bytes"]
    return nbytes, lattice_mass_ops(lat, qlat, shape["order_v"] + 1, C)
