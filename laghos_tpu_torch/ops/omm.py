"""Ozaki matmuls: f64-accurate products from exact int8 digit products.

The torch counterpart of `laghos_tpu.ops.omm`.  A product A @ B of an f64
operand A with a static operand B (a basis table) runs as

  * B split once at setup (`split_static`, host NumPy, bitwise equal to the
    JAX package's): per column a power-of-two scale and S int8 digits of
    Q = 7 bits;
  * A split per call (`split_dyn`): per row over the contraction axis a
    power-of-two scale and S digits, by the hand-written CUDA kernel
    `csrc/split.cu` for a CUDA tensor, its plain twin `split_dyn_plain` for
    a CPU tensor;
  * all digit products of significance level L = s + t < S (s the dynamic,
    t the static level) summed exactly in int32, and the levels
    recombined in floating point as the JAX package does (an f32 tail for
    L >= 4, the int32 pairing of levels (0, 1) and (2, 3)).

With S = 8 the truncation sits at ~2^-56 of the row and column maxima, at
or below the rounding of an f64 dot product.  The card has native FP64, so
this mode is measured against the native path rather than needed; it is
the JAX package's f64 production mode on the TPU, which has no FP64 ALU.

Products: ONE int8 GEMM per contraction (`torch._int_mm`) against a block
static matrix whose block (s, L) holds digit level L - s of B for s <= L:
the S level sums come out of one launch for about 2S/(S+1) (1.8x at S = 8)
the int8 work of the S level-stacked products the JAX package issues.
Int8 work is cheap on the card; launches are not (the lattice path is
host-bound).  `_int_mm` wants M > 16 and K, N multiples of 8 on the card,
so K is padded with zero digits (written by the split), N with zero
columns (static blocks, at setup) and M with zero rows where M <= 16, on
every device so the CPU tests run the same code.

Layout: the dynamic split moves the contraction axis last, so `mm`
returns A's other axes in order with B's free axis appended last, like
`torch.tensordot(A, B, dims=([axis], [0]))`.  The JAX package's `impl`
argument and `LAGHOS_PALLAS_SPLIT` are TPU dispatch knobs and are not
ported: a CUDA tensor always goes through the kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import kernels

Q = 7          # bits per slice
S_FULL = 8     # slices for full-f64 accuracy
_RADIX = float(2 ** Q)


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


@dataclasses.dataclass(frozen=True, eq=False)
class StaticSplit:
    """Pre-split static operand B (k, n): contraction dim FIRST, on the
    run's device.  `scale`, `e`, `n_slices` and (as properties) `slices`,
    `levels` and `stacks` as in the JAX package."""

    scale: torch.Tensor    # (n,) f64: 2^{eB}
    e: tuple               # (n,) exponents
    n_slices: int
    digits: torch.Tensor   # (n_slices, k, n) int8, every level
    _blocks: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def levels(self) -> tuple:
        """The levels t with a nonzero digit."""
        return tuple(t for t in range(self.n_slices)
                     if bool(self.digits[t].any()))

    @property
    def slices(self) -> tuple:
        """The (k, n) int8 digits of each of `levels`."""
        return tuple(self.digits[t] for t in self.levels)

    @property
    def stacks(self) -> tuple:
        """stacks[L] = [b_L; b_{L-1}; ...; b_0] ((L+1)k, n), the JAX
        package's level-stacked static operand."""
        return tuple(torch.cat([self.digits[L - i] for i in range(L + 1)])
                     for L in range(self.n_slices))

    def block(self, S: int) -> torch.Tensor:
        """The transposed block operand of an S-slice product, (S np, S kp)
        int8 contiguous (np, kp: n, k padded to multiples of 8): row block
        L, column block s holds b_{L-s}^T for s <= L, zeros elsewhere.
        Built once per S on the operand's device."""
        blk = self._blocks.get(S)
        if blk is None:
            nsl, k, n = self.digits.shape
            if not 1 <= S <= nsl:
                raise ValueError(f"a {S}-slice product needs S in [1, {nsl}] "
                                 "(the static split's slice count)")
            kp, n_p = _pad8(k), _pad8(n)
            bt = torch.zeros((S, n_p, S, kp), dtype=torch.int8,
                             device=self.digits.device)
            for L in range(S):
                for s in range(L + 1):
                    bt[L, :n, s, :k] = self.digits[L - s].T
            blk = bt.reshape(S * n_p, S * kp)
            self._blocks[S] = blk
        return blk


def split_static(B: np.ndarray, n_slices: int = S_FULL,
                 device="cpu") -> StaticSplit:
    """Exact per-column power-of-2 scaling + q-bit slices (host, f64); the
    arithmetic of `laghos_tpu.ops.omm.split_static`, line for line."""
    B = np.asarray(B, np.float64)
    mx = np.max(np.abs(B), axis=0, keepdims=True)
    mx = np.where(mx == 0.0, 1.0, mx)
    # |B| * 2^-e <= 1/2 so round-to-nearest keeps slice 0 <= 2^(Q-1)
    e = np.ceil(np.log2(mx)) + 1.0
    m = B * np.exp2(-e)
    dense = []
    r = m
    for t in range(n_slices):
        d = np.round(r * (2.0 ** Q))
        r = r * (2.0 ** Q) - d
        dense.append(d.astype(np.int8))
    return StaticSplit(torch.from_numpy(np.exp2(e[0])).to(device),
                       tuple(float(x) for x in e[0]), n_slices,
                       torch.from_numpy(np.stack(dense)).to(device))


@dataclasses.dataclass(frozen=True, eq=False)
class DynSplit:
    """Split dynamic operand A, contraction axis moved last.

    cat: (M, n_slices * kp) int8, row r holding level t's digits at
    [t kp, t kp + k) and zeros up to (t + 1) kp; scale: (M,) f64, 2^{eA}
    per row (NaN for a row that held NaN or Inf); lead: A's shape without
    the contraction axis (M = prod(lead))."""

    cat: torch.Tensor
    scale: torch.Tensor
    n_slices: int
    k: int
    lead: tuple


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact 2^e in f64 from exponent bits, for integer e in [-1022, 1023]."""
    return ((e.to(torch.int64) + 1023) << 52).view(torch.float64)


def _geometry(A: torch.Tensor, n_slices: int, axis: int):
    if A.dtype != torch.float64:
        raise TypeError(f"split_dyn takes float64, got {A.dtype}")
    if not 1 <= n_slices <= S_FULL:
        raise ValueError(f"n_slices must be in [1, {S_FULL}], got {n_slices}")
    if A.dim() == 0:
        raise ValueError("split_dyn needs at least one axis")
    ax = axis % A.dim()
    shape = tuple(A.shape)
    k = shape[ax]
    if k == 0:
        raise ValueError("the contraction axis is empty")
    R1 = int(np.prod(shape[:ax], dtype=np.int64))
    R2 = int(np.prod(shape[ax + 1:], dtype=np.int64))
    return shape[:ax] + shape[ax + 1:], R1, k, R2


def split_dyn_plain(A: torch.Tensor, n_slices: int = S_FULL,
                    axis: int = -1) -> DynSplit:
    """Plain torch twin of the split kernel: the same operations in the same
    order, bit for bit the same digits and scales."""
    lead, R1, k, R2 = _geometry(A, n_slices, axis)
    kp = _pad8(k)
    M = R1 * R2
    At = A.reshape(R1, k, R2).permute(0, 2, 1).reshape(M, k)
    bad = ~torch.isfinite(At).all(dim=1)
    At = torch.where(bad[:, None], torch.zeros_like(At), At)
    mx = At.abs().amax(dim=1)
    mx = torch.where(mx == 0.0, torch.ones_like(mx), mx)
    f, x = torch.frexp(mx)
    e = x.to(torch.int64) + (f != 0.5).to(torch.int64)
    # two factors keep each power of two inside the normal range
    e1 = e >> 1
    e2 = e - e1
    scale = _pow2(e1) * _pow2(e2)
    scale = torch.where(bad, torch.full_like(scale, float("nan")), scale)
    v = At * _pow2(-e1)[:, None] * _pow2(-e2)[:, None]
    cat = torch.zeros((M, n_slices, kp), dtype=torch.int8, device=A.device)
    for t in range(n_slices):
        v = v * _RADIX
        d = torch.round(v)
        v = v - d
        cat[:, t, :k] = d.to(torch.int8)
    return DynSplit(cat.reshape(M, n_slices * kp), scale, n_slices, k, lead)


def split_dyn(A: torch.Tensor, n_slices: int = S_FULL,
              axis: int = -1) -> DynSplit:
    """Per-row power-of-2 scaling + q-bit integer digits of the f64 tensor
    A over `axis`.  A CUDA tensor goes to the kernel `csrc/split.cu`
    (counted in `split_dyn.launches`), a CPU tensor to `split_dyn_plain`;
    A must be contiguous."""
    lead, R1, k, R2 = _geometry(A, n_slices, axis)
    if not A.is_contiguous():
        raise ValueError("split_dyn needs a contiguous tensor")
    if A.device.type == "cpu":
        return split_dyn_plain(A, n_slices, axis)
    if A.device.type != "cuda":
        raise NotImplementedError(f"no split kernel for {A.device}")
    kp = _pad8(k)
    M = R1 * R2
    cat = torch.empty((M, n_slices * kp), dtype=torch.int8, device=A.device)
    scale = torch.empty((M,), dtype=torch.float64, device=A.device)
    kernels.launch_split(A, cat, scale, R1=R1, k=k, R2=R2, kp=kp,
                         n_slices=n_slices)
    split_dyn.launches += 1
    return DynSplit(cat, scale, n_slices, k, lead)


split_dyn.launches = 0


def _dot_i8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 (M, K) @ (K, N) -> int32 (`torch._int_mm`, cuBLASLt on
    the card).  Holds every device to the card's shape rules: M > 16 and
    K, N multiples of 8."""
    M, K = a.shape
    N = b.shape[1]
    if M <= 16 or K % 8 or N % 8:
        raise ValueError(f"int8 product ({M}, {K}) @ ({K}, {N}) needs "
                         "M > 16 and K, N multiples of 8")
    return torch._int_mm(a, b)


def mm(dyn: DynSplit, st: StaticSplit) -> torch.Tensor:
    """f64-accurate dyn @ st: the slice pairs s + t < dyn.n_slices, one
    int8 product, the JAX package's reconstruction (omm.py:238-282).
    Returns dyn.lead + (n,)."""
    S = dyn.n_slices
    nsl, k, n = st.digits.shape
    if dyn.k != k:
        raise ValueError(f"contraction lengths differ: {dyn.k} vs {k}")
    n_p = _pad8(n)
    D = dyn.cat
    M = D.shape[0]
    if M <= 16:
        D = torch.cat([D, D.new_zeros((17 - M, D.shape[1]))])
    lev = _dot_i8(D, st.block(S).t())[:M].view(M, S, n_p)[:, :, :n]
    # levels >= 4 (weight <= 2^-42) in f32; (0, 1) and (2, 3) paired
    # exactly in int32 when (L+1) k 2^(12+Q) < 2^31 rules out overflow
    acc32 = None
    for L in range(S - 1, 3, -1):
        t32 = lev[:, L].to(torch.float32) * float(2.0 ** (-Q * (L + 2)))
        acc32 = t32 if acc32 is None else acc32 + t32
    terms = []
    for base in (2, 0):
        hi_l = lev[:, base] if base < S else None
        lo_l = lev[:, base + 1] if base + 1 < S else None
        if hi_l is None and lo_l is None:
            continue
        ok = (base + 2) * k * (2 ** (12 + Q)) < 2 ** 31
        if ok and hi_l is not None and lo_l is not None:
            terms.append((hi_l * (2 ** Q) + lo_l, 2.0 ** (-Q * (base + 3))))
        else:
            if hi_l is not None:
                terms.append((hi_l, 2.0 ** (-Q * (base + 2))))
            if lo_l is not None:
                terms.append((lo_l, 2.0 ** (-Q * (base + 3))))
    acc = None
    for S_int, w in terms:
        term = S_int.to(torch.float64) * w
        acc = term if acc is None else acc + term
    if acc32 is not None:
        acc = acc + acc32.to(torch.float64)
    out = acc * dyn.scale[:, None] * st.scale[None, :]
    return out.reshape(tuple(dyn.lead) + (n,))


def matmul(A: torch.Tensor, B_static: StaticSplit,
           n_slices: int = S_FULL) -> torch.Tensor:
    """One-shot A (..., k) @ B (k, n) with a fresh dynamic split."""
    return mm(split_dyn(A.contiguous(), n_slices), B_static)


def tensordot(A: torch.Tensor, st: StaticSplit, axis: int,
              n_slices: int = S_FULL) -> torch.Tensor:
    """f64-accurate torch.tensordot(A, B, dims=([axis], [0])): the
    contracted axis is replaced by B's free axis, appended LAST."""
    return mm(split_dyn(A.contiguous(), n_slices, axis=axis), st)
