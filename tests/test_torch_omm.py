"""The port's Ozaki products (`laghos_tpu_torch/ops/omm.py`) on the CPU:
the static splits bit for bit against the JAX package's, the plain twin of
the split kernel (`split_dyn_plain`) on its own, and the products against
the JAX package's `omm.mm` and the f64 `tensordot`.

Tolerances: the two packages choose the dynamic exponent by different
rules (and the JAX XLA split scales through an inexact exp2), so digits
are never compared across packages: reconstructions and products are.  A
split of S slices reconstructs its row to 2^(-7S+2) of the row maximum
(the bound of tests/test_pallas_split.py); a product at S = 8 matches the
f64 product to 1e-14 of its maximum (the bound of test_pallas_split.py's
test_mm_matches_xla_split)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laghos_tpu.ops import lattice as jlat
from laghos_tpu.ops import omm as jomm
from laghos_tpu.ops import pallas_split as jps
from laghos_tpu.ops import tensor as jtensor
from laghos_tpu_torch.fem import basis as tbasis
from laghos_tpu_torch.interop import _split_arrays
from laghos_tpu_torch.ops import omm
from laghos_tpu_torch.ops import tensor as ttensor

torch.set_num_threads(1)


def _mixed_operand(shape, seed=0, spread=30):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) * np.exp2(
        rng.integers(-spread, spread, shape))


def _levels(d):
    """(M, S, k) digits of a DynSplit as f64."""
    S = d.n_slices
    return d.cat.view(d.cat.shape[0], S, -1)[:, :, :d.k].double()


def _reconstruct(d):
    """(M, k) reconstruction of a DynSplit (rows in the split's order)."""
    lv = _levels(d)
    w = torch.tensor([2.0 ** (-omm.Q * (t + 1)) for t in range(d.n_slices)],
                     dtype=torch.float64)
    return (lv * w[None, :, None]).sum(1) * d.scale[:, None]


def _rows(A, axis):
    """A's rows over `axis`, in the split's row order: (M, k)."""
    return torch.movedim(A, axis, -1).reshape(-1, A.shape[axis])


def _tables(ok=2, ot=1):
    nq = 2 * ok
    h1 = tbasis.h1_gl_basis(ok, nq)
    l2 = tbasis.l2_bernstein_basis(ot, nq)
    return h1, l2


def _static_cases():
    h1, l2 = _tables()
    bd, gds = ttensor.dense_ops(h1.B, h1.G, 3)
    l2bd, _ = ttensor.dense_ops(l2.B, np.zeros_like(l2.B), 3)
    gcat = np.concatenate(gds, axis=0)
    T = jlat.banded_eval_table(np.asarray(h1.B), 4)
    Tg = jlat.banded_eval_table(np.asarray(h1.G), 3)
    return {"banded_B": T, "banded_G_T": Tg.T, "dense_h1": bd,
            "dense_gcatT": gcat.T, "dense_l2": l2bd,
            "mixed": _mixed_operand((9, 12), seed=4)}


@pytest.mark.parametrize("name", sorted(_static_cases()))
@pytest.mark.parametrize("S", [8, 6])
def test_split_static_bitwise_equals_jax(name, S):
    B = _static_cases()[name]
    t = _split_arrays(omm.split_static(B, S))
    j = jomm.split_static(B, S)
    assert t["levels"] == tuple(j.levels) and t["e"] == tuple(j.e)
    assert t["n_slices"] == j.n_slices == S
    np.testing.assert_array_equal(t["scale"], np.asarray(j.scale))
    assert len(t["slices"]) == len(j.slices)
    for a, b in zip(t["slices"] + t["stacks"], j.slices + j.stacks):
        assert a.dtype == np.int8
        np.testing.assert_array_equal(a, np.asarray(b))


def test_dense_ops_match_jax():
    h1, _ = _tables(4, 3)
    bt, gt = ttensor.dense_ops(h1.B, h1.G, 3)
    bj, gj = jtensor.dense_ops(h1.B, h1.G, 3)
    np.testing.assert_array_equal(bt, bj)
    for a, b in zip(gt, gj):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("S", [8, 6, 4])
def test_plain_split_reconstructs_within_bound(axis, S):
    A = torch.tensor(_mixed_operand((3, 17, 33)))
    A[1, :, 5] = 0.0                      # an all-zero row along axis 1
    d = omm.split_dyn_plain(A, S, axis)
    rows = _rows(A, axis)
    k = A.shape[axis]
    kp = -(-k // 8) * 8
    assert d.cat.dtype == torch.int8 and d.cat.shape == (rows.shape[0],
                                                          S * kp)
    lv = d.cat.view(-1, S, kp)
    assert int(lv.min()) >= -64 and int(lv.max()) <= 64
    assert bool((lv[:, :, k:] == 0).all())          # K padding
    mant, _ = torch.frexp(d.scale)
    assert bool((mant == 0.5).all())                 # exact powers of two
    mx = rows.abs().amax(1, keepdim=True)
    err = ((_reconstruct(d) - rows).abs() / mx.clamp_min(1e-300)).max()
    assert float(err) <= 2.0 ** (-omm.Q * S + 2)
    assert d.lead == tuple(s for i, s in enumerate(A.shape) if i != axis)


def test_plain_split_integer_exact():
    rng = np.random.default_rng(3)
    B = torch.tensor(rng.integers(-1000, 1000, (4, 9, 8)).astype(float))
    d = omm.split_dyn_plain(B, 8, 1)
    assert torch.equal(_reconstruct(d), _rows(B, 1))


def test_split_exponent_rule_at_powers_of_two():
    """e = ceil(log2 max|row|) + 1 exactly, at and beside powers of two,
    down to subnormal row maxima."""
    mx = [1.0, 0.5, 0.75, 2.0 ** 40, 2.0 ** 40 * (1 + 2 ** -52),
          2.0 ** -1060, 3.0, 0.0]
    A = torch.tensor(mx, dtype=torch.float64)[:, None] * torch.tensor(
        [[1.0, -0.25, 0.5]], dtype=torch.float64)
    d = omm.split_dyn_plain(A, 8)
    want = [1, 0, 1, 41, 42, -1059, 3, 1]
    assert d.scale.tolist() == [2.0 ** e for e in want]
    assert torch.equal(_reconstruct(d)[:7], A[:7])


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")])
def test_nonfinite_row_poisons_only_its_products(bad):
    rng = np.random.default_rng(7)
    A = torch.tensor(rng.standard_normal((20, 24)))
    A[6, 3] = bad
    st = omm.split_static(rng.standard_normal((24, 10)))
    d = omm.split_dyn(A, 8)
    assert torch.isnan(d.scale[6]) and bool((d.cat[6] == 0).all())
    y = omm.mm(d, st)
    fin = torch.isfinite(y)
    assert not bool(fin[6].any())
    assert bool(fin[torch.arange(20) != 6].all())


def _jax_mm(A, B, axis, S):
    """JAX package's product over its XLA split, and the f64 tensordot."""
    Aj = jnp.asarray(A)
    st = jomm.split_static(B, 8)
    got = jomm.mm(jomm.split_dyn(Aj, S, axis=axis, impl="xla"), st,
                  axis=axis)
    exact = jnp.tensordot(Aj, jnp.asarray(B), axes=[[axis], [0]])
    return np.asarray(got), np.asarray(exact)


@pytest.mark.parametrize("shape,axis,n", [
    ((3, 17, 29), 1, 12),        # test_pallas_split's shape
    ((2, 65, 9), 1, 65),         # k = 65 and n = 65 (the ns2 lattice axes)
    ((5, 65), 1, 128),           # M = 5 <= 16: row padding
    ((4, 3, 64), 2, 8),          # M = 12 <= 16, k = NQ
    ((7, 8, 6), 0, 27),          # contraction over the first axis
])
def test_mm_matches_jax_and_f64(shape, axis, n):
    rng = np.random.default_rng(5)
    A = rng.standard_normal(shape)
    B = rng.standard_normal((shape[axis], n))
    got = omm.tensordot(torch.tensor(A), omm.split_static(B, 8), axis, 8)
    ref, exact = _jax_mm(A, B, axis, 8)
    assert got.shape == exact.shape
    scale = np.abs(exact).max()
    assert np.abs(got.numpy() - exact).max() / scale < 1e-14
    assert np.abs(got.numpy() - ref).max() / scale < 1e-14


@pytest.mark.parametrize("S", [7, 6, 4])
def test_truncated_products_match_jax(S):
    """Fewer dynamic slices than the static build (the IR residual and
    q-update gradients): the same truncation class as the JAX package."""
    rng = np.random.default_rng(8)
    A = rng.standard_normal((6, 33, 10))
    B = rng.standard_normal((33, 20))
    got = omm.tensordot(torch.tensor(A), omm.split_static(B, 8), 1, S)
    ref, exact = _jax_mm(A, B, 1, S)
    scale = np.abs(exact).max()
    bound = 2.0 ** (-omm.Q * S + 8)
    assert np.abs(got.numpy() - exact).max() / scale < bound
    assert np.abs(got.numpy() - ref).max() / scale < bound


def test_matmul_and_block_operand():
    """matmul = one-shot split over the last axis; the block operand holds
    b_{L-s}^T in block (L, s) and is cached per slice count."""
    rng = np.random.default_rng(9)
    A = torch.tensor(rng.standard_normal((4, 5, 27)))
    B = rng.standard_normal((27, 64))
    st = omm.split_static(B)
    y = omm.matmul(A, st)
    exact = A @ torch.tensor(B)
    assert float((y - exact).abs().max() / exact.abs().max()) < 1e-14
    blk = st.block(3)
    assert blk.shape == (3 * 64, 3 * 32) and blk.is_contiguous()
    assert st.block(3) is blk
    v = blk.view(3, 64, 3, 32)
    assert torch.equal(v[2, :, 1, :27], st.digits[1].T)
    assert bool((v[0, :, 1] == 0).all()) and bool((v[:, :, :, 27:] == 0).all())
    with pytest.raises(ValueError):
        st.block(9)


def test_split_matches_pallas_interpret_reconstruction():
    """The port's split and the TPU kernel's interpret mode reconstruct the
    same operand within the bound (their exponents may differ by one)."""
    A = _mixed_operand((3, 17, 33), seed=2)
    A[1, :, 5] = 0.0
    S = 8
    cat, e = jps.split_cat_pallas(jnp.asarray(A), S, 1, interpret=True,
                                  bc=16)
    rec_j = 0.0
    for t in range(S):
        sl = jax.lax.slice_in_dim(cat, t * 17, (t + 1) * 17, axis=1)
        rec_j = rec_j + sl.astype(jnp.float64) * 2.0 ** (-omm.Q * (t + 1))
    rec_j = np.asarray(rec_j * jps.exact_pow2(e))
    At = torch.tensor(A)
    rec_t = _reconstruct(omm.split_dyn_plain(At, S, 1))
    rows = _rows(At, 1)
    mx = rows.abs().amax(1, keepdim=True).clamp_min(1e-300)
    bound = 2.0 ** (-omm.Q * S + 2)
    rec_jr = _rows(torch.tensor(rec_j), 1)
    assert float(((rec_t - rows).abs() / mx).max()) <= bound
    assert float(((rec_jr - rows).abs() / mx).max()) <= bound
    assert float(((rec_t - rec_jr).abs() / mx).max()) <= 2 * bound


def test_split_dyn_checks_and_cpu_dispatch():
    A = torch.randn(20, 16, dtype=torch.float64)
    before = omm.split_dyn.launches
    d = omm.split_dyn(A, 8)
    p = omm.split_dyn_plain(A, 8)
    assert omm.split_dyn.launches == before      # the CPU runs the twin
    assert torch.equal(d.cat, p.cat) and torch.equal(d.scale, p.scale)
    with pytest.raises(TypeError):
        omm.split_dyn(A.float())
    with pytest.raises(ValueError):
        omm.split_dyn(A.t())                     # not contiguous
    with pytest.raises(ValueError):
        omm.split_dyn(A, 9)
    with pytest.raises(ValueError):
        omm._dot_i8(torch.zeros(16, 8, dtype=torch.int8),
                    torch.zeros(8, 8, dtype=torch.int8))
    with pytest.raises(ValueError):
        omm.mm(omm.split_dyn(A, 8), omm.split_static(np.ones((15, 8))))
