"""The element PA mass apply (`ops/mass.mass_apply_e`, on the card
`csrc/mass.cu`) as the energy CG applies it: the L2 mass of one component
on every element.  Its least work from its shapes.

Bytes: u (NE, ld) and the q-point weights D (NE, NQ) read once, y (NE, ld)
written once.  Operations: the sum factorization's 2 dim 1D contractions,
two (a multiply-add) for each contracted value of each output, and one
multiply by D a q-point (`mass_ops`, chip_smoke.py:796-803)."""

# device-side names (the compiled and runtime-size instances); one launch
# an apply
KERNELS = ("mass_kernel",)
CALL = "mass_kernel"


def mass_ops(dim, nd1, nq1, NE, C):
    macs = sum(nq1 ** (s + 1) * nd1 ** (dim - s)
               + nd1 ** (s + 1) * nq1 ** (dim - s) for s in range(dim))
    return C * NE * (2 * macs + nq1 ** dim)


def work(shape):
    """(bytes, operations) of one apply of the L2 mass."""
    dim, NE, nq1 = shape["dim"], shape["elements"], shape["nq1"]
    l1d = shape["order_e"] + 1
    nbytes = (2 * NE * l1d ** dim + NE * nq1 ** dim) * shape["dtype_bytes"]
    return nbytes, mass_ops(dim, l1d, nq1, NE, 1)
