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
// two, rounding to an integer, and the subtraction of the rounded digit),
// so the digits land in [-64, 64] directly and there is no carry pass.
//
// Exponent: computed exactly from frexp (mx = f 2^x, f in [1/2, 1): e = x
// when f = 1/2, else x + 1), never through log2/exp2, which are inexact
// even on integers.  An all-zero row takes mx = 1 (e = 1), as in the JAX
// package.  Powers of two are built from exponent bits in two factors
// 2^e1 2^e2 (e1 = e >> 1), as the plain twin builds them, so both stay in
// the normal range.  The JAX kernel picks e by floor(log2) + 2 with an
// overflow check, so its digits may differ from these by one exponent;
// both are valid splits of the same value.
//
// Rounding: for |x| <= 2^51, x + 1.5 2^52 rounds to 1.5 2^52 + rint(x),
// to nearest even exactly as rint does (the ulp there is 1 and 1.5 2^52 is
// even), and the low word of its bits is rint(x) mod 2^32.  The digits come
// in closed form from such roundings of 2^(7t) A 2^-e, one FP64 operation a
// level with no chain between levels (see digits()), bit for bit the
// cascade's.  That keeps the work on the FP64 add/multiply pipes and off
// the conversion units.
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
// Threads: a block of 128 threads takes a tile of `rows` consecutive rows
// (a power of two from 4 to 128, about 2,048 elements: 33 KB of shared
// memory at k = 128, six blocks an SM) and splits the contraction axis
// among its threads, so the flagship's 49,152-row q-lattice stage launches
// 3,072 blocks (the one-thread-per-row version filled a fifth of one
// wave).
//  * Copy, once and coalesced, into shared memory with cp.async, every copy
//    of the tile in flight at once and none through registers: for R2 > 1
//    (every lattice-path split) a thread keeps one row and walks j, so a
//    warp reads runs of consecutive r2 at each j; for R2 = 1 (omm.matmul)
//    the tile's rows x k are one contiguous run and are read flat.
//  * Each row is taken by g lanes of one warp (g the power of two that
//    covers kp, up to 32): its max and finiteness by a shuffle reduction
//    (no atomics; the max is order-independent, so the bits are the plain
//    twin's), its scale, then its digits (in closed form, see digits()),
//    with no block barrier in between.  The digits are staged in shared
//    memory in D's layout: a tile of consecutive rows is one contiguous
//    block of D, written with 16-byte stores.
//  * Rows longer than a tile of 4 (k > 512; 1,536 at Q4, 4,096 at Q8) are
//    cut into chunks of k: the first pass over the chunks takes the row
//    max, the second reloads each chunk (from L2: a tile is 4 rows of A,
//    49 KB at k = 1,536) and writes its digits as one 8-byte-word run per
//    row and level.
//
// What bounds it: each element moves 8 bytes in and S bytes out, plus 8
// bytes of scale per row: about 100 MB at S = 8 for the flagship's
// q-lattice stage (3 x 128^3 elements), 30 us at the data-sheet 3.35 TB/s.
// The FP64 work is 4 + S operations per element, 2 more at S = 8 (14),
// a tenth of the byte time, so bytes bound it.  On an H100 (700 W) the six
// stage splits of one 8-slice mass apply reach about 43 % of their byte
// bound with a cold L2 (0.190 ms), and the flat gather-path force operand
// about 77 % (PERF.md's kernel table).  At Q8-Q7 (rs3: k = 129 and 256,
// tiles of 8 rows) the six stages reach about 61 %, and the L2 pair's
// (4096, 4096) operand, chunked, about 46 %.  A scratch build with the same
// copies, shared-memory traffic and stores but no max and no cascade
// reached about 51 % at the six stages: the memory side is most of the
// time.  Its R2 > 1 stages run at about 80 % of the flat rate: a tile's
// reads are runs of `rows` x 8 bytes, one for each of k columns R2 apart.
// Tried and not kept (no faster): loads batched through registers, a
// persistent grid copying the next tile during this one, 256-thread blocks
// with tiles of 4,096 elements, tiles of 1,024, larger tiles with each
// row's digits written over its own values, L2 prefetch hints on the
// copies.
//
// No fast math: IEEE multiply/add, no flush to zero.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = kThreads;        // a thread keeps one row in the loads
constexpr int kMinRows = kWarps;          // every warp owns a row in the max
constexpr int kTileElems = 2048;          // elements a tile aims at
constexpr int kSmemBudget = 110 * 1024;    // dynamic shared memory per block, at most
constexpr int kMaxDevices = 64;
constexpr double kRadix = 128.0;          // 2^Q, Q = 7 bits per digit
constexpr double kMagic = 6755399441055744.0;  // 1.5 * 2^52

__host__ __device__ constexpr int64_t align16(int64_t n) { return (n + 15) & ~int64_t(15); }

// exact 2^e for integer e in [-1022, 1023], from exponent bits
__device__ __forceinline__ double pow2(int e) {
  return __longlong_as_double(static_cast<long long>(e + 1023) << 52);
}

struct Tiling {
  int rows;     // rows per tile: a power of two in [kMinRows, kMaxRows]
  int kc;       // columns per chunk: kp (one chunk) or a multiple of 8
  int nchunk;   // chunks per row
  int64_t smem; // dynamic shared memory bytes
};

// values: rows x (kc + 1) f64 (odd stride: no bank conflicts when a warp
// reads down a column); digits: rows x S x kc bytes, plus 16 for aligning
// the staged block with D
__host__ __device__ constexpr int64_t smem_bytes(int rows, int kc, int S) {
  return align16(int64_t(rows) * (kc + 1) * 8) + int64_t(rows) * S * kc + 16;
}

Tiling choose_tiling(int64_t M, int kp, int S, int sms) {
  Tiling t{0, kp, 1, 0};
  if (int64_t(kMinRows) * kp <= kTileElems && smem_bytes(kMinRows, kp, S) <= kSmemBudget) {
    // the most rows, up to about kTileElems elements and within the budget
    t.rows = kMinRows;
    while (t.rows < kMaxRows && int64_t(2 * t.rows) * kp <= kTileElems &&
           smem_bytes(2 * t.rows, kp, S) <= kSmemBudget) {
      t.rows *= 2;
    }
    // small operands: smaller tiles, so the grid still spreads over the SMs
    while (t.rows > kMinRows && (M + t.rows - 1) / t.rows < 2 * int64_t(sms)) t.rows >>= 1;
  } else {  // k too long for one tile: chunks of k, kMinRows rows
    t.rows = kMinRows;
    const int64_t kc_max = kTileElems / kMinRows / 8 * 8 > 8 ? kTileElems / kMinRows / 8 * 8 : 8;
    const int64_t n = (kp + kc_max - 1) / kc_max;
    t.kc = static_cast<int>(((kp + n - 1) / n + 7) / 8 * 8);  // even chunks
    t.nchunk = (kp + t.kc - 1) / t.kc;
  }
  t.smem = smem_bytes(t.rows, t.kc, S);
  return t;
}

__device__ __forceinline__ void cp_async8(double* smem_dst, const double* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}

// Columns [c0, c0 + kcc) of the tile's nr rows into vals[rr * ldv + jj]
// with cp.async, then waits for them: every copy in flight at once, none
// through registers.
__device__ __forceinline__ void copy_cols(const double* __restrict__ A, double* vals, int ldv,
                                          int64_t row0, int nr, int rows, int k, int64_t R2,
                                          int c0, int kcc) {
  const int tid = threadIdx.x;
  if (R2 > 1) {
    // this thread's row is fixed (rows divides kThreads); a warp reads
    // runs of consecutive r2 at each j
    const int rr = tid & (rows - 1);
    if (rr < nr) {
      const int64_t row = row0 + rr;
      const int64_t r1 = row / R2;
      const double* col = A + r1 * k * R2 + (row - r1 * R2) + int64_t(c0) * R2;
      for (int j = tid / rows; j < kcc; j += kThreads / rows) {
        cp_async8(vals + rr * ldv + j, col + int64_t(j) * R2);
      }
    }
  } else {
    // R2 == 1: row rr's columns are A[(row0 + rr) k + c0 + c]; with the
    // whole row (kcc == k) the tile is one contiguous run, read flat
    const double* base = A + row0 * k + c0;
    const int n = nr * kcc;
    const int drr = kThreads / kcc, dc = kThreads - drr * kcc;
    int rr = tid / kcc, c = tid - rr * kcc;
    for (int i = tid; i < n; i += kThreads) {
      cp_async8(vals + rr * ldv + c, base + int64_t(rr) * k + c);
      rr += drr;
      c += dc;
      if (c >= kcc) {
        c -= kcc;
        ++rr;
      }
    }
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The row's scale factors: mx = f 2^x, e = x (f = 1/2) or x + 1; an
// all-zero row takes mx = 1.  A * p1 * p2 = A * 2^-e exactly.
__device__ __forceinline__ void row_scale(double mx, int& e1, int& e2) {
  if (mx == 0.0) mx = 1.0;
  int x;
  const double f = frexp(mx, &x);
  const int e = (f == 0.5) ? x : x + 1;
  e1 = e >> 1;
  e2 = e - e1;
}

// The S digits of one scaled value u (|u| <= 1/2) at o[t * stride], in
// closed form.  The cascade's partial integer after level t is N_t =
// rint(2^(7t) u): N_t = 128 N_(t-1) + rint(2^(7t) u - 128 N_(t-1)), and
// rint(x - n) + n = rint(x) for even n, ties to even included.  So d_t =
// N_t - 128 N_(t-1) with N_0 = 0, and for t <= 7 (|2^(7t) u| <= 2^48) each
// N_t is the low word of fma(u, 2^(7t), 1.5 2^52), one exact FP64 operation
// and no chain between levels.  Level 8 takes the cascade's last step from
// the exact remainder 2^49 u - N_7.  Only the low byte of each d_t is kept,
// which integer wrap-around leaves exact.
template <int S>
__device__ __forceinline__ void digits(double u, unsigned char* o, int stride) {
  constexpr int kDirect = S < 7 ? S : 7;
  int prev = 0;
  double y = 0.0, pw = 1.0;  // pw = 2^(7t), constants once unrolled
#pragma unroll
  for (int t = 1; t <= kDirect; ++t) {
    pw *= kRadix;
    y = fma(u, pw, kMagic);
    const int lo = __double2loint(y);
    o[(t - 1) * stride] = static_cast<unsigned char>(lo - (prev << 7));
    prev = lo;
  }
  if (S == 8) {
    const double r7 = fma(u, pw, -(y - kMagic));  // pw = 2^49
    o[7 * stride] = static_cast<unsigned char>(__double2loint(fma(r7, kRadix, kMagic)));
  }
}

// The digits of columns jj (lane's first), jj + g, ... < wc of one row,
// staged as o[t * wc + jj].
template <int S>
__device__ __forceinline__ void row_digits(const double* vrow, unsigned char* o, int l, int g,
                                           int kcc, int wc, bool bad, double p1, double p2) {
  for (int jj = l; jj < wc; jj += g) {
    const double v = (jj < kcc && !bad) ? vrow[jj] : 0.0;
    digits<S>(v * p1 * p2, o + jj, wc);
  }
}

// Max of |v| and finiteness over the g lanes of a row.
__device__ __forceinline__ void reduce_row(double& m, int& fin, int g) {
  for (int o = g >> 1; o > 0; o >>= 1) {
    m = fmax(m, __shfl_xor_sync(0xffffffffu, m, o));
    fin &= __shfl_xor_sync(0xffffffffu, fin, o);
  }
}

template <int S>
__global__ void __launch_bounds__(kThreads)
    split_kernel(const double* __restrict__ A, int8_t* __restrict__ D, double* __restrict__ scale,
                 int64_t M, int k, int64_t R2, int kp, Tiling tl) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double s_mx[kMinRows], s_p1[kMinRows], s_p2[kMinRows];
  __shared__ int s_bad[kMinRows];
  const int rows = tl.rows, kc = tl.kc, nchunk = tl.nchunk;
  const int ldv = kc + 1;
  double* vals = reinterpret_cast<double*>(smem);
  unsigned char* stage = smem + align16(int64_t(rows) * ldv * 8);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the reductions and the digits take a row per g lanes, g the power of
  // two in [1, 32] that covers a chunk's columns best
  int g = 32;
  while (g > 1 && (g >> 1) >= min(kc, kp)) g >>= 1;
  const int per_warp = 32 / g, sub = lane / g, l = lane - sub * g;
  const int row_step = kWarps * per_warp;
  const int64_t row_bytes = int64_t(S) * kp;
  const int64_t ntiles = (M + rows - 1) / rows;

  if (nchunk == 1) {
    // whole tiles in shared memory; each row's g lanes take its max, its
    // scale and its digits with no block barrier between them
    for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int64_t row0 = tile * rows;
      const int nr = static_cast<int>(M - row0 < rows ? M - row0 : rows);
      int8_t* dst = D + row0 * row_bytes;
      copy_cols(A, vals, ldv, row0, nr, rows, k, R2, 0, k);
      __syncthreads();
      // the staged tile is D's block byte for byte, placed at the same
      // offset mod 16 as dst so the copy-out is 16-byte aligned
      const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);
      unsigned char* st = stage + shift;
      for (int base = warp * per_warp; base < nr; base += row_step) {  // warp-uniform
        const int rr = base + sub;
        const bool live = rr < nr;
        const double* vrow = vals + rr * ldv;
        double m = 0.0;
        int fin = 1;
        if (live) {
          for (int jj = l; jj < k; jj += g) {
            const double v = vrow[jj];
            fin &= isfinite(v);
            m = fmax(m, fabs(v));
          }
        }
        reduce_row(m, fin, g);
        if (live) {
          int e1, e2;
          row_scale(m, e1, e2);
          if (l == 0) {
            scale[row0 + rr] =
                fin ? pow2(e1) * pow2(e2) : __longlong_as_double(0x7ff8000000000000LL);
          }
          row_digits<S>(vrow, st + rr * row_bytes, l, g, k, kp, !fin, pow2(-e1), pow2(-e2));
        }
      }
      __syncthreads();  // after it the values may be refilled; the stage
                        // is rewritten only past the next tile's first barrier
      // the tile's nr rows are one contiguous block of D
      const int64_t nb = int64_t(nr) * row_bytes;
      int64_t head = 0;
      if (shift) {  // shift is 8: one 8-byte word brings dst to 16
        head = 8;
        if (tid == 0) *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(st);
      }
      const int64_t n16 = (nb - head) >> 4;
      const uint4* s16 = reinterpret_cast<const uint4*>(st + head);
      uint4* d16 = reinterpret_cast<uint4*>(dst + head);
      for (int64_t i = tid; i < n16; i += kThreads) d16[i] = s16[i];
      const int64_t tail = head + n16 * 16;
      if (tail < nb && tid == 0) {
        *reinterpret_cast<uint2*>(dst + tail) = *reinterpret_cast<const uint2*>(st + tail);
      }
    }
    return;
  }

  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t row0 = tile * rows;
    const int nr = static_cast<int>(M - row0 < rows ? M - row0 : rows);
    int8_t* dst = D + row0 * row_bytes;

    // k in chunks (rows == kMinRows): pass 1 takes the row max and
    // finiteness, pass 2 reloads each chunk (from L2) for its digits
    if (tid < rows) {
      s_mx[tid] = 0.0;
      s_bad[tid] = 0;
    }
    for (int c = 0; c < nchunk; ++c) {
      const int c0 = c * kc;
      const int kcc = min(kc, k - c0);
      copy_cols(A, vals, ldv, row0, nr, rows, k, R2, c0, kcc);
      __syncthreads();
      for (int base = warp * per_warp; base < nr; base += row_step) {
        const int rr = base + sub;
        double m = 0.0;
        int fin = 1;
        if (rr < nr) {
          for (int jj = l; jj < kcc; jj += g) {
            const double v = vals[rr * ldv + jj];
            fin &= isfinite(v);
            m = fmax(m, fabs(v));
          }
        }
        reduce_row(m, fin, g);
        if (rr < nr && l == 0) {
          s_mx[rr] = fmax(s_mx[rr], m);
          if (!fin) s_bad[rr] = 1;
        }
      }
      __syncthreads();
    }
    if (tid < nr) {
      int e1, e2;
      row_scale(s_mx[tid], e1, e2);
      s_p1[tid] = pow2(-e1);
      s_p2[tid] = pow2(-e2);
      scale[row0 + tid] =
          s_bad[tid] ? __longlong_as_double(0x7ff8000000000000LL) : pow2(e1) * pow2(e2);
    }
    __syncthreads();
    for (int c = 0; c < nchunk; ++c) {
      const int c0 = c * kc;
      const int kcc = min(kc, k - c0);  // real columns
      const int wc = min(kc, kp - c0);  // with the zero padding
      copy_cols(A, vals, ldv, row0, nr, rows, k, R2, c0, kcc);
      __syncthreads();
      for (int rr = warp * per_warp + sub; rr < nr; rr += row_step) {
        row_digits<S>(vals + rr * ldv, stage + rr * S * wc, l, g, kcc, wc, s_bad[rr], s_p1[rr],
                      s_p2[rr]);
      }
      __syncthreads();
      // one run of wc bytes per row and level at D[row, t kp + c0]
      const int words = wc >> 3;
      const int nw = nr * S * words;
      for (int i = tid; i < nw; i += kThreads) {
        const int run = i / words, w = i - run * words;
        const int rr = run / S, t = run - rr * S;
        *reinterpret_cast<uint2*>(dst + rr * row_bytes + int64_t(t) * kp + c0 + 8 * w) =
            *reinterpret_cast<const uint2*>(stage + (rr * S + t) * wc + 8 * w);
      }
      __syncthreads();  // the stage and the values are reused
    }
  }
}

template <int S>
cudaError_t launch(const double* A, int8_t* D, double* scale, int64_t M, int k, int64_t R2,
                   int kp, int device, int sms, cudaStream_t stream) {
  const Tiling tl = choose_tiling(M, kp, S, sms);
  // once per device: host calls cost microseconds on a host-bound path
  static bool ready[kMaxDevices] = {};
  if (!ready[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        split_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
    if (err != cudaSuccess) return err;
    ready[device] = true;
  }
  int64_t blocks = (M + tl.rows - 1) / tl.rows;
  if (blocks > (1 << 30)) blocks = 1 << 30;  // the tile loop covers the rest
  split_kernel<S><<<static_cast<unsigned>(blocks), kThreads, static_cast<size_t>(tl.smem),
                    stream>>>(A, D, scale, M, k, R2, kp, tl);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  A: (R1, k, R2) f64, contiguous; D:
// (R1 * R2, n_slices * kp) int8, 8-byte aligned; scale: (R1 * R2,) f64; kp
// a multiple of 8 with kp >= k, below 2^31; 1 <= n_slices <= 8.  Launches on
// `stream` (PyTorch's current stream), allocates nothing, does not
// synchronise, and returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments outside those ranges).
extern "C" int split_launch(int device, const void* A, void* D, void* scale, int64_t R1,
                            int64_t k, int64_t R2, int64_t kp, int n_slices, void* stream) {
  if (R1 < 0 || R2 < 0 || k < 1 || kp < k || kp % 8 != 0 || kp > (int64_t(1) << 31) - 8 ||
      reinterpret_cast<uintptr_t>(D) % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t M = R1 * R2;
  if (M == 0) return static_cast<int>(cudaSuccess);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  static int sms_of[kMaxDevices] = {};
  if (sms_of[device] == 0) {
    err = cudaDeviceGetAttribute(&sms_of[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int sms = sms_of[device];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const double* a = static_cast<const double*>(A);
  int8_t* d = static_cast<int8_t*>(D);
  double* sc = static_cast<double*>(scale);
  const int ki = static_cast<int>(k), kpi = static_cast<int>(kp);
  switch (n_slices) {
    case 1: err = launch<1>(a, d, sc, M, ki, R2, kpi, device, sms, s); break;
    case 2: err = launch<2>(a, d, sc, M, ki, R2, kpi, device, sms, s); break;
    case 3: err = launch<3>(a, d, sc, M, ki, R2, kpi, device, sms, s); break;
    case 4: err = launch<4>(a, d, sc, M, ki, R2, kpi, device, sms, s); break;
    case 5: err = launch<5>(a, d, sc, M, ki, R2, kpi, device, sms, s); break;
    case 6: err = launch<6>(a, d, sc, M, ki, R2, kpi, device, sms, s); break;
    case 7: err = launch<7>(a, d, sc, M, ki, R2, kpi, device, sms, s); break;
    case 8: err = launch<8>(a, d, sc, M, ki, R2, kpi, device, sms, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
