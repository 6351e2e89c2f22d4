"""The assembled H1 mass times one velocity component (`ops/assemble.
csr_apply` makes one such product a component, each a cuSPARSE SpMV
through torch's sparse CSR matmul): its least bytes from its shapes.

The matrix is the scalar H1 mass of Q_p elements on an n^3 cube, assembled
(full assembly, `-fa`).  Its nonzeros are the product over the three axes
of the 1D count n (p + 1)^2 - (n - 1): each element couples its p + 1
nodes an axis with each other, and the n - 1 shared end nodes are counted
twice.  Bytes: the values (dtype) and the int32 column indices once a
nonzero, the int32 row pointers once a row and one more, the input
vector read once and the output written once.  Operations are not
counted (a multiply-add a nonzero, 0.17 operation a byte in f64): the
bound is the bytes."""

import math

# device-side names of the kernels of one cuSPARSE CSR SpMV, in the
# namespace they all share: the row partition (csr_partition_kernel), the
# scaling of y by beta (vector_scalar_multiply_kernel) and the product
# (csrmv_v3_kernel), each launched once a product (torch 2.11, CUDA 12.8)
KERNELS = ("cusparse::",)
CALL = "csrmv_v3_kernel"
INDEX_BYTES = 4


def nonzeros(shape):
    """Nonzeros of the assembled scalar H1 mass on the cube."""
    p = shape["order_v"]
    out = 1
    for L in shape["h1_lattice"]:
        n = (L - 1) // p
        out *= n * (p + 1) ** 2 - (n - 1)
    return out


def work(shape):
    """(bytes, None) of one product with one vector."""
    nnz, rows = nonzeros(shape), math.prod(shape["h1_lattice"])
    b = shape["dtype_bytes"]
    nbytes = (b + INDEX_BYTES) * nnz + INDEX_BYTES * (rows + 1) + 2 * b * rows
    return nbytes, None
