// The conjugate-gradient iteration's vector algebra as one chain of kernels,
// for Hopper (sm_90a).
//
// laghos_tpu_torch/solvers/cg.py runs, per iteration of a solve of C
// independent rows (C, n) (the velocity components, or the one energy row):
//   broke = active & (den <= 0); alpha = nom / den
//   x += alpha d;  r -= alpha Ad;  z = dinv r (or r);  betanom = (r, z)
//   conv = active & (betanom <= r0); beta = betanom / nom; nom = betanom
//   d = z + beta d;  Ad = mask(A d);  den = (d, Ad)
// with each row frozen (its count recorded) where it breaks down or
// converges.  The eager version takes about 35 PyTorch launches and about
// 36 passes over a (C, n) vector; this chain takes five kernels around the
// caller's operator apply:
//   cg_update_kernel     per row: the breakdown guard, x and r updated in
//                        place, z formed in registers (never stored), one
//                        partial of (r, z) a block;
//   cg_finish_kernel     one block: the partials summed in a fixed order,
//                        the breakdown and convergence tests, iters, beta,
//                        nom, active and the int32 any-row-active flag the
//                        host reads (one read an iteration at most, as
//                        before);
//   cg_direction_kernel  d = dinv r + beta d on the active rows (z again
//                        from r and dinv, the same value as in the update);
//   (the operator apply on d: csrc/lattice_mass.cu, csrc/mass.cu)
//   cg_ess_dot_kernel    the essential-dof mask written into the apply's
//                        output, which becomes Ad (no copy), and one
//                        partial of (d, Ad) a block;
//   cg_den_kernel        one block: den = (d, Ad) in a fixed order.
// It replaces no TPU kernel: the JAX package's CG (laghos_tpu/solvers/
// cg.py) is left to XLA, which fuses the same element-wise work.
//
// Semantics: every element-wise product and sum is rounded on its own
// (__dmul_rn, __dadd_rn: no contraction into an FMA), as PyTorch's
// element-wise kernels round them, so x, r and d take the eager
// iteration's values from the same alpha and beta; only the dots are
// summed in another order (each thread in index order, then a fixed
// shuffle tree in its block, then the blocks' partials in a fixed order
// in one block): no atomics, so two launches give the same bits.  A row
// that is not active is left untouched (no read, no write: an exact no-op
// iteration).  Its Ad is dead from then on (a row never comes back), so
// the apply's output becomes Ad whole.
//
// What bounds it: bytes.  At the Q2-Q1 velocity solve (C 3, n 2,146,689,
// f64, dinv (n,) shared, bool mask (3, n)) an iteration must move 436 MB
// (x, r, d read and written, Ad and the apply's output read, dinv and the
// mask read, each byte once): 0.130 ms at 3.35 TB/s.  The chain moves 608
// MB (the update reads x, d, r, Ad and dinv and writes x and r, the
// direction reads r, d and dinv again and writes d, the mask-and-dot reads
// the apply's output, d and the mask), about 12 passes over a (3, n)
// vector against the eager iteration's 36.  At the energy solve (C 1, n
// 2,097,152, no preconditioner, no mask): 134 MB needed, 201 MB moved,
// 0.040 ms.  The finishers read a few KB.  On an H100 (700 W), every row
// active, the chain takes 0.295 ms (44.1 % of its bound) and 0.081 ms
// (49.7 %) with a cold L2 (PERF.md's kernel table); profiled, the
// finishers take 3-5 us each, the update 0.139 ms, the direction 0.071
// and the mask-and-dot 0.045 at the velocity shape.  The design:
// grid-stride loops over one wave of blocks (the occupancy of the update
// kernel times the SMs, split among the rows), coalesced 8-byte loads,
// nothing staged in shared memory, and the two finishers as single blocks
// so that no reduction needs a second grid-wide pass or an atomic.
//
// No fast math: IEEE division, no flush to zero.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }

// The sum of v over the block in a fixed order (a shuffle tree in each
// warp, then one over the warps' sums), valid in thread 0.  Every thread of
// the block calls it; it may be called again right after.
template <typename T>
__device__ T block_sum(T v) {
  __shared__ T warp_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? warp_sums[lane] : T(0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  __syncthreads();
  return v;
}

// The row c's partials part[c * P, c * P + P) summed in a fixed order,
// valid in thread 0 (a one-block kernel).
template <typename T>
__device__ T row_sum(const T* __restrict__ part, int c, int P) {
  T s = T(0);
  for (int j = threadIdx.x; j < P; j += kThreads) s += part[int64_t(c) * P + j];
  return block_sum(s);
}

// Step 1: grid (P, C).  x += alpha d, r -= alpha Ad, z = dinv r, and one
// partial of (r, z) a block, on a row active and not broken down.
template <typename T, bool kDiag>
__global__ void __launch_bounds__(kThreads)
    cg_update_kernel(int64_t n, T* __restrict__ x, T* __restrict__ r, const T* __restrict__ d,
                     const T* __restrict__ Ad, const T* __restrict__ dinv, int64_t dinv_stride,
                     const T* __restrict__ nom, const T* __restrict__ den,
                     const bool* __restrict__ active, T* __restrict__ part) {
  const int c = blockIdx.y;
  const T dn = den[c];
  T acc = T(0);
  if (active[c] && !(dn <= T(0))) {
    const T alpha = nom[c] / dn;
    const int64_t off = int64_t(c) * n;
    const T* __restrict__ dr = kDiag ? dinv + int64_t(c) * dinv_stride : nullptr;
    const int64_t step = int64_t(gridDim.x) * kThreads;
    for (int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x; i < n; i += step) {
      x[off + i] = add_rn(x[off + i], mul_rn(alpha, d[off + i]));
      const T rv = sub_rn(r[off + i], mul_rn(alpha, Ad[off + i]));
      r[off + i] = rv;
      const T z = kDiag ? mul_rn(rv, dr[i]) : rv;
      acc = fma(rv, z, acc);
    }
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) part[int64_t(c) * gridDim.x + blockIdx.x] = acc;
}

// Step 2: one block.  betanom of each row from the partials, the
// breakdown and convergence tests at iteration `it`, beta (0 on a row no
// longer active), nom, and the flag.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    cg_finish_kernel(int C, int P, const T* __restrict__ part, int64_t it, T* __restrict__ nom,
                     const T* __restrict__ den, const T* __restrict__ r0, bool* __restrict__ active,
                     int64_t* __restrict__ iters, T* __restrict__ beta, int* __restrict__ flag) {
  bool any = false;
  for (int c = 0; c < C; ++c) {
    const T s = row_sum(part, c, P);
    if (threadIdx.x == 0) {
      bool act = active[c];
      if (act && den[c] <= T(0)) {
        iters[c] = it;
        act = false;
      }
      if (act && s <= r0[c]) {
        iters[c] = it;
        act = false;
      }
      const T nm = nom[c];
      beta[c] = act ? s / (nm == T(0) ? T(1) : nm) : T(0);
      if (act) nom[c] = s;
      active[c] = act;
      any = any || act;
    }
  }
  if (threadIdx.x == 0) *flag = any ? 1 : 0;
}

// Step 3: grid (P, C).  d = z + beta d on an active row.
template <typename T, bool kDiag>
__global__ void __launch_bounds__(kThreads)
    cg_direction_kernel(int64_t n, const T* __restrict__ r, T* __restrict__ d,
                        const T* __restrict__ dinv, int64_t dinv_stride,
                        const bool* __restrict__ active, const T* __restrict__ beta) {
  const int c = blockIdx.y;
  if (!active[c]) return;
  const T bm = beta[c];
  const int64_t off = int64_t(c) * n;
  const T* __restrict__ dr = kDiag ? dinv + int64_t(c) * dinv_stride : nullptr;
  const int64_t step = int64_t(gridDim.x) * kThreads;
  for (int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x; i < n; i += step) {
    const T rv = r[off + i];
    const T z = kDiag ? mul_rn(rv, dr[i]) : rv;
    d[off + i] = add_rn(z, mul_rn(bm, d[off + i]));
  }
}

// Step 5: grid (P, C).  On an active row, y = 0 at the essential dofs
// (written there only) and one partial of (d, y) a block; y becomes Ad.
template <typename T, bool kEss>
__global__ void __launch_bounds__(kThreads)
    cg_ess_dot_kernel(int64_t n, T* __restrict__ y, const bool* __restrict__ ess,
                      int64_t ess_stride, const T* __restrict__ d,
                      const bool* __restrict__ active, T* __restrict__ part) {
  const int c = blockIdx.y;
  T acc = T(0);
  if (active[c]) {
    const int64_t off = int64_t(c) * n;
    const bool* __restrict__ er = kEss ? ess + int64_t(c) * ess_stride : nullptr;
    const int64_t step = int64_t(gridDim.x) * kThreads;
    for (int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x; i < n; i += step) {
      T v = y[off + i];
      if (kEss && er[i]) {
        v = T(0);
        y[off + i] = v;
      }
      acc = fma(d[off + i], v, acc);
    }
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) part[int64_t(c) * gridDim.x + blockIdx.x] = acc;
}

// Step 6: one block.  den = (d, Ad) on the active rows.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    cg_den_kernel(int C, int P, const T* __restrict__ part, const bool* __restrict__ active,
                  T* __restrict__ den) {
  for (int c = 0; c < C; ++c) {
    const T s = row_sum(part, c, P);
    if (threadIdx.x == 0 && active[c]) den[c] = s;
  }
}

// Blocks of the update kernel resident on one SM of `device`, times the
// SMs: one wave.  Cached per device and type.
template <typename T>
cudaError_t wave(int device, int* out) {
  static int cached[kMaxDevices] = {};
  if (cached[device] == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cg_update_kernel<T, true>,
                                                        kThreads, 0);
    if (err != cudaSuccess) return err;
    cached[device] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *out = cached[device];
  return cudaSuccess;
}

int64_t partials(int wave_blocks, int64_t C, int64_t n) {
  const int64_t need = (n + kThreads - 1) / kThreads;
  const int64_t share = (wave_blocks + C - 1) / C;
  const int64_t P = need < share ? need : share;
  return P > 0 ? P : 1;
}

bool bad_sizes(int dtype, int device, int64_t C, int64_t n, int64_t P) {
  return (dtype != 0 && dtype != 1) || device < 0 || device >= kMaxDevices || C < 1 ||
         C > 65535 || n < 1 || n > (int64_t(1) << 40) || P < 1 || P > (int64_t(1) << 30);
}

template <typename T>
cudaError_t step(int64_t C, int64_t n, int64_t P, int64_t it, void* x, void* r, void* d,
                 const void* Ad, const void* dinv, int64_t dinv_stride, void* nom, const void* den,
                 const void* r0, void* active, void* iters, void* beta, void* part, void* flag,
                 cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(P), static_cast<unsigned>(C));
  T* xs = static_cast<T*>(x);
  T* rs = static_cast<T*>(r);
  T* ds = static_cast<T*>(d);
  const T* Ads = static_cast<const T*>(Ad);
  const T* dv = static_cast<const T*>(dinv);
  T* ps = static_cast<T*>(part);
  const bool* act = static_cast<const bool*>(active);
  if (dv) {
    cg_update_kernel<T, true><<<grid, kThreads, 0, s>>>(n, xs, rs, ds, Ads, dv, dinv_stride,
                                                        static_cast<const T*>(nom),
                                                        static_cast<const T*>(den), act, ps);
  } else {
    cg_update_kernel<T, false><<<grid, kThreads, 0, s>>>(n, xs, rs, ds, Ads, dv, 0,
                                                         static_cast<const T*>(nom),
                                                         static_cast<const T*>(den), act, ps);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cg_finish_kernel<T><<<1, kThreads, 0, s>>>(
      static_cast<int>(C), static_cast<int>(P), ps, it, static_cast<T*>(nom),
      static_cast<const T*>(den), static_cast<const T*>(r0), static_cast<bool*>(active),
      static_cast<int64_t*>(iters), static_cast<T*>(beta), static_cast<int*>(flag));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (dv) {
    cg_direction_kernel<T, true>
        <<<grid, kThreads, 0, s>>>(n, rs, ds, dv, dinv_stride, act, static_cast<const T*>(beta));
  } else {
    cg_direction_kernel<T, false>
        <<<grid, kThreads, 0, s>>>(n, rs, ds, dv, 0, act, static_cast<const T*>(beta));
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t ess_dot(int64_t C, int64_t n, int64_t P, void* y, const void* ess,
                    int64_t ess_stride, const void* d, void* den, const void* active, void* part,
                    cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(P), static_cast<unsigned>(C));
  T* ys = static_cast<T*>(y);
  const bool* es = static_cast<const bool*>(ess);
  const T* ds = static_cast<const T*>(d);
  const bool* act = static_cast<const bool*>(active);
  T* ps = static_cast<T*>(part);
  if (es) {
    cg_ess_dot_kernel<T, true><<<grid, kThreads, 0, s>>>(n, ys, es, ess_stride, ds, act, ps);
  } else {
    cg_ess_dot_kernel<T, false><<<grid, kThreads, 0, s>>>(n, ys, es, 0, ds, act, ps);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cg_den_kernel<T><<<1, kThreads, 0, s>>>(static_cast<int>(C), static_cast<int>(P), ps, act,
                                           static_cast<T*>(den));
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  dtype: 0 f32, 1 f64.  Vectors are
// contiguous (C, n) on `device`; dinv and ess are (n,) (stride 0) or (C, n)
// (stride n), or null (no preconditioner, no mask); nom, den, r0, beta
// (C,) of the type, active (C,) bool, iters (C,) int64, flag one int32,
// part (C, P) of the type with P from cg_partials.  Launches go on `stream`
// (PyTorch's current stream), allocate nothing and do not synchronise.
// Each returns cudaGetLastError() after its last launch (it stops at the
// first that fails), or cudaErrorInvalidValue for arguments out of range.

// cg_partials: P, the blocks a row of a (C, n) solve launches (so the
// partials of a dot are (C, P)), or a negative CUDA error.
extern "C" int64_t cg_partials(int dtype, int device, int64_t C, int64_t n) {
  if (bad_sizes(dtype, device, C, n, 1)) return -static_cast<int64_t>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = dtype ? wave<double>(device, &blocks) : wave<float>(device, &blocks);
  }
  return err == cudaSuccess ? partials(blocks, C, n) : -static_cast<int64_t>(err);
}

// cg_step_launch: steps 1-3 of iteration `it` (the update, the finisher,
// the direction).
extern "C" int cg_step_launch(int dtype, int device, int64_t C, int64_t n, int64_t P, int64_t it,
                              void* x, void* r, void* d, const void* Ad, const void* dinv,
                              int64_t dinv_stride, void* nom, const void* den, const void* r0,
                              void* active, void* iters, void* beta, void* part, void* flag,
                              void* stream) {
  if (bad_sizes(dtype, device, C, n, P)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = dtype ? step<double>(C, n, P, it, x, r, d, Ad, dinv, dinv_stride, nom, den, r0, active,
                             iters, beta, part, flag, s)
              : step<float>(C, n, P, it, x, r, d, Ad, dinv, dinv_stride, nom, den, r0, active,
                            iters, beta, part, flag, s);
  return static_cast<int>(err);
}

// cg_ess_dot_launch: step 5 and its finisher: y (the apply's output) masked
// in place at the essential dofs, den = (d, y) on the active rows.
extern "C" int cg_ess_dot_launch(int dtype, int device, int64_t C, int64_t n, int64_t P, void* y,
                                 const void* ess, int64_t ess_stride, const void* d, void* den,
                                 const void* active, void* part, void* stream) {
  if (bad_sizes(dtype, device, C, n, P)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = dtype ? ess_dot<double>(C, n, P, y, ess, ess_stride, d, den, active, part, s)
              : ess_dot<float>(C, n, P, y, ess, ess_stride, d, den, active, part, s);
  return static_cast<int>(err);
}
