// Exact Ozaki split of an f64 operand into int8 digits, for Hopper (sm_90a).
//
// Replaces the TPU kernel laghos_tpu/ops/pallas_split.py::split_cat_pallas,
// the fused form of laghos_tpu/ops/omm.py::split_dyn.  For A viewed as
// (R1, k, R2) and split over its middle (contraction) axis, every row
// (r1, r2) gets
//   * a power-of-two scale 2^e with e = ceil(log2 max_j |A[r1, j, r2]|) + 1,
//     so |A * 2^-e| <= 1/2 (omm.split_dyn's rule);
//   * S digits d_t in [-64, 64] (Q = 7 bits each) with
//     A * 2^-e = sum_t d_t 2^-7(t+1) + remainder, |remainder| <= 2^-7S / 2,
//     from the cascade  v *= 2^7;  d = rint(v);  v -= d.
// The plain PyTorch twin is laghos_tpu_torch/ops/omm.py::split_dyn_plain;
// the two agree bit for bit.
//
// Why no hi/lo/lo2 parts: the TPU has no FP64 ALU, so its kernel took the
// operand as three f32 parts, cascaded each in f32 and needed a carry pass
// to bring the summed digits back into int8 range.  Here every step of the
// cascade is exact in native FP64 for one f64 value (scaling by a power of
// two with scalbn, rint, and the subtraction of the rounded digit), so the
// digits land in [-64, 64] directly and there is no carry pass.
//
// Exponent: computed exactly from frexp (mx = f 2^x, f in [1/2, 1): e = x
// when f = 1/2, else x + 1), never through log2/exp2, which are inexact
// even on integers.  An all-zero row takes mx = 1 (e = 1), as in the JAX
// package.  The JAX kernel picks e by floor(log2) + 2 with an overflow
// check, so its digits may differ from these by one exponent; both are
// valid splits of the same value.
//
// Non-finite rows: a row holding NaN or Inf gets zero digits and a NaN
// scale, so every product row built from it is NaN and the hydro step's
// finiteness guard still rejects the step (jnp.max/log2 make such rows
// non-finite in JAX too).  fmax would drop a NaN, and a NaN converted to
// int8 would become a silent digit, so the row is tested with isfinite.
//
// Output layout (the one the int8 product wants, not JAX's): row
// r = r1 * R2 + r2 of D (R1 * R2, S * kp) holds level t's digits at columns
// [t * kp, t * kp + k), zero digits in [t * kp + k, (t + 1) * kp); kp is k
// rounded up to a multiple of 8 (the int8 GEMM's K rule).  scale is
// (R1 * R2,) f64, exact powers of two.
//
// Threads: one thread per row, r2 the fastest index, so the strided loads
// of A[r1, j, r2] over j coalesce across a warp.  Two passes over k: the
// row max, then the digits (the second read is served from L1/L2).  Digits
// are packed 8 to a 64-bit word per level and stored with one 8-byte write.
//
// What bounds it: each element moves 8 bytes in and S bytes out, plus 8
// bytes of scale per row.  The largest flagship calls (3D Sedov Q2-Q1 rs4:
// the q-lattice stages of the mass apply, 3 x 128^3 = 6.29 M elements) move
// about 100 MB at S = 8, about 30 us at the data-sheet 3.35 TB/s.  The FP64
// work (S multiply/rint/subtract per element) is far below the FP64 rate.
// With one thread per row the grid holds only 12,675 to 49,152 threads at
// that size, well under one full wave of the card, so latency rather than
// bandwidth is expected to bound this first version.
//
// No fast math: IEEE scalbn/rint, no flush to zero.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kBlock = 128;
constexpr double kRadix = 128.0;  // 2^Q, Q = 7 bits per digit

template <int S>
__global__ void split_kernel(const double* __restrict__ A, int8_t* __restrict__ D,
                             double* __restrict__ scale, int64_t R1, int64_t k, int64_t R2,
                             int64_t kp) {
  const int64_t M = R1 * R2;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; row < M;
       row += stride) {
    const int64_t r1 = row / R2;
    const int64_t r2 = row - r1 * R2;
    const double* a = A + r1 * k * R2 + r2;  // element j at a[j * R2]
    int8_t* out = D + row * static_cast<int64_t>(S) * kp;

    double mx = 0.0;
    bool finite = true;
    for (int64_t j = 0; j < k; ++j) {
      const double v = a[j * R2];
      finite = finite && isfinite(v);
      mx = fmax(mx, fabs(v));
    }
    if (!finite) {
      scale[row] = __longlong_as_double(0x7ff8000000000000LL);  // NaN
      for (int64_t j0 = 0; j0 < kp; j0 += 8) {
#pragma unroll
        for (int t = 0; t < S; ++t) *reinterpret_cast<uint64_t*>(out + t * kp + j0) = 0ull;
      }
      continue;
    }
    if (mx == 0.0) mx = 1.0;
    int x;
    const double f = frexp(mx, &x);
    const int e = (f == 0.5) ? x : x + 1;
    scale[row] = scalbn(1.0, e);

    for (int64_t j0 = 0; j0 < kp; j0 += 8) {
      uint64_t w[S];
#pragma unroll
      for (int t = 0; t < S; ++t) w[t] = 0ull;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int64_t j = j0 + jj;
        double v = (j < k) ? scalbn(a[j * R2], -e) : 0.0;
#pragma unroll
        for (int t = 0; t < S; ++t) {
          v *= kRadix;
          const double d = rint(v);
          v -= d;
          const uint8_t byte = static_cast<uint8_t>(static_cast<int8_t>(static_cast<int>(d)));
          w[t] |= static_cast<uint64_t>(byte) << (8 * jj);
        }
      }
#pragma unroll
      for (int t = 0; t < S; ++t) *reinterpret_cast<uint64_t*>(out + t * kp + j0) = w[t];
    }
  }
}

template <int S>
void launch(const double* A, int8_t* D, double* scale, int64_t R1, int64_t k, int64_t R2,
            int64_t kp, cudaStream_t stream) {
  int64_t blocks = (R1 * R2 + kBlock - 1) / kBlock;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride loop covers the rest
  if (blocks < 1) blocks = 1;
  split_kernel<S><<<static_cast<unsigned>(blocks), kBlock, 0, stream>>>(A, D, scale, R1, k, R2,
                                                                        kp);
}

}  // namespace

// Plain C interface for ctypes.  A: (R1, k, R2) f64, contiguous; D:
// (R1 * R2, n_slices * kp) int8; scale: (R1 * R2,) f64; kp a multiple of 8
// with kp >= k; 1 <= n_slices <= 8.  Launches on `stream` (PyTorch's current
// stream), allocates nothing, does not synchronise, and returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for arguments
// outside those ranges).
extern "C" int split_launch(int device, const void* A, void* D, void* scale, int64_t R1,
                            int64_t k, int64_t R2, int64_t kp, int n_slices, void* stream) {
  if (R1 < 0 || R2 < 0 || k < 1 || kp < k || kp % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R1 * R2 == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const double* a = static_cast<const double*>(A);
  int8_t* d = static_cast<int8_t*>(D);
  double* sc = static_cast<double*>(scale);
  switch (n_slices) {
    case 1: launch<1>(a, d, sc, R1, k, R2, kp, s); break;
    case 2: launch<2>(a, d, sc, R1, k, R2, kp, s); break;
    case 3: launch<3>(a, d, sc, R1, k, R2, kp, s); break;
    case 4: launch<4>(a, d, sc, R1, k, R2, kp, s); break;
    case 5: launch<5>(a, d, sc, R1, k, R2, kp, s); break;
    case 6: launch<6>(a, d, sc, R1, k, R2, kp, s); break;
    case 7: launch<7>(a, d, sc, R1, k, R2, kp, s); break;
    case 8: launch<8>(a, d, sc, R1, k, R2, kp, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
