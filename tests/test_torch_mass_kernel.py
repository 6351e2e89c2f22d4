"""The element PA mass apply of the PyTorch port against the JAX package, on
the CPU: `ops/mass.mass_apply_e_plain` (the plain twin of the CUDA kernel
`csrc/mass.cu`) against `laghos_tpu.ops.mass.mass_apply_e` on the same
seeded inputs, in 1D, 2D and 3D, for the L2 table (one component) and the
H1 table (dim components) of orders 1, 2, 4 and 8; and the wrapper
`mass_apply_e` on CPU tensors: the twin, no launch, refusals.  The kernel
itself is held to the twin on the card (tests/test_torch_kernels.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laghos_tpu.ops import mass as jmass
from laghos_tpu_torch.fem import basis as tbasis
from laghos_tpu_torch.fem import quadrature as tquad
from laghos_tpu_torch.ops import mass as tmass

NE = 8


def _operands(dim, order, table, dtype, seed=0):
    """(u (C, NE, nd1^dim), D (NE, nq1^dim), B (nq1, nd1)) as numpy arrays
    of `dtype`: the port's 1D table of `table` ("L2": Bernstein of order
    order - 1, one component; "H1": Gauss-Lobatto of `order`, dim
    components) at the Gauss points of the default rule of (order,
    order - 1), with seeded u and positive D."""
    nq1 = tquad.points_for_order(tquad.default_rule_order(order, order - 1))
    if table == "L2":
        B = tbasis.l2_bernstein_basis(order - 1, nq1).B
        C = 1
    else:
        B = tbasis.h1_gl_basis(order, nq1).B
        C = dim
    nd1 = B.shape[1]
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((C, NE, nd1**dim))
    D = rng.uniform(0.5, 1.5, (NE, nq1**dim))
    return u.astype(dtype), D.astype(dtype), np.asarray(B, dtype=dtype)


def _rel(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max()
                 / np.abs(np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-14),
                                       (np.float32, 1e-6)])
@pytest.mark.parametrize("order", [1, 2, 4, 8])
@pytest.mark.parametrize("table", ["L2", "H1"])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_mass_apply_plain_matches_jax(dim, table, order, dtype, tol):
    u, D, B = _operands(dim, order, table, dtype)
    y_t = tmass.mass_apply_e_plain(torch.tensor(u), torch.tensor(D),
                                   torch.tensor(B), dim)
    y_j = np.asarray(jmass.mass_apply_e(jnp.asarray(u), jnp.asarray(D),
                                        jnp.asarray(B), dim))
    assert y_t.dtype == torch.tensor(u).dtype
    assert tuple(y_t.shape) == u.shape
    assert _rel(y_t.numpy(), y_j) <= tol


@pytest.mark.parametrize("dim,order,table", [(1, 2, "H1"), (2, 4, "L2"),
                                             (3, 2, "H1"), (3, 8, "L2")])
def test_mass_apply_cpu_runs_the_twin(dim, order, table):
    """On CPU tensors the wrapper is the twin, bit for bit, and launches
    nothing; a leading-free (NE, nd) operand (the energy CG's) and a
    strided view (the gather path's transposed E-vector) give the same
    bits as their contiguous (1, NE, nd) copies."""
    u, D, B = (torch.tensor(a) for a in _operands(dim, order, table,
                                                   np.float64, seed=3))
    before = tmass.mass_apply_e.launches
    y = tmass.mass_apply_e(u, D, B, dim)
    assert torch.equal(y, tmass.mass_apply_e_plain(u, D, B, dim))
    assert torch.equal(tmass.mass_apply_e(u[0], D, B, dim), y[0])
    view = u.transpose(0, 1).contiguous().transpose(0, 1)
    assert not view.is_contiguous() or u.shape[0] == 1
    assert torch.equal(tmass.mass_apply_e(view, D, B, dim), y)
    assert tmass.mass_apply_e.launches == before


def test_mass_apply_refuses_mismatched_operands():
    u, D, B = (torch.tensor(a) for a in _operands(3, 2, "H1", np.float64))
    before = tmass.mass_apply_e.launches
    with pytest.raises(TypeError, match="dtypes differ"):
        tmass.mass_apply_e(u.float(), D, B, 3)
    with pytest.raises(TypeError, match="dtypes differ"):
        tmass.mass_apply_e(u, D, B.float(), 3)
    with pytest.raises(ValueError, match="shapes do not fit"):
        tmass.mass_apply_e(u[..., :-1], D, B, 3)        # nd1^dim
    with pytest.raises(ValueError, match="shapes do not fit"):
        tmass.mass_apply_e(u, D[:, :-1], B, 3)          # nq1^dim
    with pytest.raises(ValueError, match="shapes do not fit"):
        tmass.mass_apply_e(u[:, :-1], D, B, 3)          # NE
    with pytest.raises(ValueError, match="shapes do not fit"):
        tmass.mass_apply_e(u, D, B, 2)                  # dim
    with pytest.raises(ValueError, match="needs B"):
        tmass.mass_apply_e(u, D, B[0], 3)
    with pytest.raises(ValueError, match="dim must be"):
        tmass.mass_apply_e(u, D, B, 4)
    assert tmass.mass_apply_e.launches == before


def test_host_table_is_cached_per_tensor_and_version():
    """`kernels.host_table`, the 1D table the compiled mass kernels take as
    a kernel parameter: the tensor's values, copied once per tensor object
    and version (a second call returns the same copy), copied again after
    an in-place change, and forgotten when the tensor dies."""
    from laghos_tpu_torch.ops import kernels

    B = torch.tensor(np.random.default_rng(3).standard_normal((16, 9)))
    first = kernels.host_table(B)
    assert torch.equal(first, B) and first.is_contiguous()
    assert kernels.host_table(B) is first
    B.mul_(2.0)
    again = kernels.host_table(B)
    assert again is not first and torch.equal(again, B)
    assert torch.equal(first * 2.0, B)          # a copy, not a view of B
    key = id(B)
    del B
    assert key not in kernels._HOST_TABLES
    with torch.inference_mode():
        Bi = torch.ones((4, 2))
    assert torch.equal(kernels.host_table(Bi), Bi)
