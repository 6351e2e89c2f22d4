// Element partial-assembly mass apply for Hopper (sm_90a).
//
// Computes, for every element e and component c,
//   out[c, e] = B^T (D[e] * (B u[c, e]))
// with the 1D table B (nq1, nd1) applied along each of the dim axes of the
// element's dof tensor (nd1^dim values, x fastest) and its transpose along
// each axis of the q-point tensor (nq1^dim values, x fastest): MFEM's PA
// mass apply (SmemPAMassApply2D/3D), the reference's MassPAOperator
// (laghos_assembly.cpp:80-121).  u and out are (C, NE, nd1^dim), D is
// (NE, nq1^dim), all contiguous, f32 or f64.
//
// Replaces laghos_tpu/ops/mass.py::mass_apply_e, which the JAX package
// leaves to XLA (no Pallas kernel): there a chain of 2 dim tensordots, and
// in the port's plain twin (laghos_tpu_torch/ops/mass.py::
// mass_apply_e_plain) the same chain of torch.tensordot calls with a
// movedim copy after each, 4 dim device passes over the q-point tensor.
// Users: the energy CG's operator on every partial-assembly path (C = 1),
// the gather path's velocity operator (C = dim).
//
// What bounds it: each element reads nd1^dim values of u per component and
// nq1^dim of D, and writes nd1^dim; the arithmetic is 2 nd1 nq1 (nd1^2 +
// nd1 nq1 + nq1^2) multiply-adds an element and component in 3D.  At Q8-Q7
// (L2: nd1 8, nq1 16; NE 4,096) that is 168 MB and 0.94 GFLOP in f64: 50 us
// of bytes at 3.35 TB/s against 14 us of FP64 at the 67 TFLOP/s the card's
// tensor cores give batched f64 products (28 us at 34 TFLOP/s outside
// them), so bytes bound it, D being 134 MB of the 168.
//
// Design.  Nothing leaves the chip between the first contraction and the
// last: one block takes one element (or, when nq1^dim is small, EPB
// elements, about 2,048 q-points a block) and runs all 2 dim contractions
// through two shared-memory buffers, the D product folded into the last
// forward contraction and the last transpose contraction storing straight
// to device memory.
//  * Each contraction takes the fastest axis of its input and puts its new
//    axis slowest (u[z][y][x] -> [qx][z][y] -> [qy][qx][z] -> [qz][qy][qx]),
//    so after dim contractions the axes are back in order: every stage
//    reads rows of K contiguous values and the D product and the final
//    store index the output flat, as D and out are laid out.
//  * A stage's input is R rows of K values at an odd row stride (K rounded
//    up to odd): a warp's lanes read down a column of consecutive rows, and
//    an odd stride puts them in distinct banks (f32 and f64 alike).
//  * A thread takes one row (its K values into registers) and a group of
//    QG of the Q outputs of that row, so each value it loads from shared
//    memory serves QG multiply-adds; the group count is chosen so every
//    stage has about as many (row, group) items as the block has threads.
//    The table is read from shared memory at one address across the lanes
//    that share a group (a broadcast).
//  * D's values for a thread's outputs of the D stage are loaded into
//    registers before the first contraction (their latency hidden behind
//    the forward stages) and serve every component: D is read once from
//    device memory for all C components.
//  * Each output is one fused multiply-add chain over its K inputs in
//    ascending order: no atomics, no order that depends on timing, so two
//    launches give the same bits.
// The sizes (nd1, nq1) of orders 1-4, 6 and 8 (L2 (k, 2k) and H1
// (k + 1, 2k)) in 2D and 3D are compiled with their loops unrolled; any
// other size, and every 1D size, runs one runtime-size kernel with the same
// layout (its products read shared memory directly, and it reads D at the
// D stage of each component).  Both take their shared memory dynamically,
// above 48 KB after cudaFuncSetAttribute: two buffers and the table twice,
// (buf0 + buf1 + 2 nd1 nq1) values, 55.3 KB at Q8-Q7 L2 and 56.7 KB at H1 in
// f64.  A size whose buffers exceed the card's opt-in limit (232,448 bytes
// on an H100) is refused (kTooLarge) and raised by the wrapper; in 3D f64
// the largest order that fits is -ok 12 (H1 (13, 24): 182,592 bytes; -ok 13's
// H1 (14, 26) needs 232,960).
//
// No fast math: IEEE multiply/add, no flush to zero.

#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

namespace {

constexpr int kThreads = 256;
constexpr int kPoints = 2048;      // q-points a block aims at (elements a block)
constexpr int kMaxDevices = 64;
constexpr int kTooLarge = 20001;   // not a cudaError_t: the shared memory a block may have

__host__ __device__ constexpr int ipow(int b, int e) {
  int p = 1;
  for (int i = 0; i < e; ++i) p *= b;
  return p;
}
__host__ __device__ constexpr int odd(int k) { return k | 1; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

__device__ __forceinline__ float fmad(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fmad(double a, double b, double c) { return __fma_rn(a, b, c); }

__host__ __device__ constexpr int elems_per_block(int dim, int q1) {
  return imax(1, kPoints / ipow(q1, dim));
}

// Stage j of 2 dim: j < dim contracts the fastest dof axis with B (K = nd1
// in, Q = nq1 out), j >= dim the fastest q axis with B^T (K = nq1, Q = nd1).
struct Geo {
  int K, Q;          // contracted length, outputs a row
  int R, P;          // rows of the input and their stride
  int Bn, Pn, Rn;    // the next stage's row length, row stride and rows
  int NG, QG;        // q groups a row and outputs a group
  int items;         // (element, group, row) work items of the block
};

__host__ __device__ constexpr Geo geo(int dim, int d1, int q1, int epb, int j) {
  const bool fwd = j < dim;
  const int s = fwd ? j : j - dim;
  Geo g{};
  g.K = fwd ? d1 : q1;
  g.Q = fwd ? q1 : d1;
  g.R = fwd ? ipow(q1, s) * ipow(d1, dim - 1 - s) : ipow(d1, s) * ipow(q1, dim - 1 - s);
  g.P = odd(g.K);
  // the next stage contracts the fastest axis left in the row index, or
  // (at the last forward stage) the first q axis
  g.Bn = s < dim - 1 ? g.K : q1;
  g.Pn = odd(g.Bn);
  g.Rn = dim > 1 ? g.Q * g.R / g.Bn : 1;
  const int ng = imin(imax(cdiv(kThreads, epb * g.R), 1), g.Q);
  g.QG = cdiv(g.Q, ng);
  g.NG = cdiv(g.Q, g.QG);
  g.items = epb * g.NG * g.R;
  return g;
}

// values of buffer b (0: inputs of the even stages, 1: of the odd ones)
__host__ __device__ constexpr int buf_size(int dim, int d1, int q1, int epb, int b) {
  int n = 0;
  for (int j = b; j < 2 * dim; j += 2) {
    const Geo g = geo(dim, d1, q1, epb, j);
    n = imax(n, epb * g.R * g.P);
  }
  return n;
}

__host__ __device__ constexpr int64_t smem_bytes(int dim, int d1, int q1, int size) {
  const int epb = elems_per_block(dim, q1);
  return (int64_t(buf_size(dim, d1, q1, epb, 0)) + buf_size(dim, d1, q1, epb, 1) +
          2 * d1 * q1) * size;
}

// where output q of row r of element el of a non-final stage goes in the
// next stage's input: row (q, a) of the next stage, column b, r = a Bn + b
__device__ __forceinline__ int next_index(const Geo& g, int dim, int el, int q, int r) {
  if (dim == 1) return el * g.Pn + q;
  const int a = r / g.Bn, b = r - a * g.Bn;
  return (el * g.Rn + q * (g.R / g.Bn) + a) * g.Pn + b;
}

template <typename T>
struct Smem {
  T* buf[2];
  T* B;    // (nq1, nd1): M[q][k] of the forward stages
  T* Bt;   // (nd1, nq1): M[i][q] of the transpose stages
};

template <typename T>
__device__ __forceinline__ Smem<T> carve(unsigned char* raw, int b0, int b1, int d1, int q1) {
  T* p = reinterpret_cast<T*>(raw);
  Smem<T> s;
  s.buf[0] = p;
  s.buf[1] = p + b0;
  s.B = p + b0 + b1;
  s.Bt = s.B + d1 * q1;
  return s;
}

template <typename T>
__device__ __forceinline__ void load_tables(const Smem<T>& s, const T* __restrict__ B, int d1,
                                            int q1) {
  for (int i = threadIdx.x; i < d1 * q1; i += kThreads) {
    const T b = B[i];
    const int q = i / d1, k = i - q * d1;
    s.B[i] = b;
    s.Bt[k * q1 + q] = b;
  }
}

// component c's dof values of the block's elements into buffer 0, as rows
// of nd1 at stride odd(nd1); elements past NE read as 0
template <typename T>
__device__ __forceinline__ void load_u(T* __restrict__ dst, const T* __restrict__ uc, int nd,
                                       int d1, int R0, int epb, int ne) {
  const int P0 = odd(d1);
  for (int f = threadIdx.x; f < epb * nd; f += kThreads) {
    const int el = f / nd, rem = f - el * nd;
    const int r = rem / d1, k = rem - r * d1;
    dst[(el * R0 + r) * P0 + k] = el < ne ? uc[f] : T(0);
  }
}

// ------------------------------------------------- compiled sizes --------
template <typename T, int DIM, int D1, int Q1, int J, int ITD, int QGD>
__device__ __forceinline__ void stage(const Smem<T>& s, const T (&dv)[ITD][QGD],
                                      T* __restrict__ outc, int ne) {
  constexpr int EPB = elems_per_block(DIM, Q1);
  constexpr Geo G = geo(DIM, D1, Q1, EPB, J);
  constexpr bool kFwd = J < DIM;
  constexpr bool kDStage = J == DIM - 1;
  constexpr bool kLast = J == 2 * DIM - 1;
  constexpr int ND = ipow(D1, DIM);
  constexpr int IT = cdiv(G.items, kThreads);
  const T* in = s.buf[J & 1];
  T* nxt = s.buf[(J + 1) & 1];
  const T* M = kFwd ? s.B : s.Bt;
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int i = threadIdx.x + it * kThreads;
    if (G.items % kThreads != 0 && i >= G.items) break;
    const int r = i % G.R;
    const int grp = (i / G.R) % G.NG;
    const int el = i / (G.R * G.NG);
    T v[G.K];
    const T* row = in + (el * G.R + r) * G.P;
#pragma unroll
    for (int k = 0; k < G.K; ++k) v[k] = row[k];
#pragma unroll
    for (int qq = 0; qq < G.QG; ++qq) {
      const int q = grp * G.QG + qq;
      if (G.Q % G.QG != 0 && q >= G.Q) break;
      const T* m = M + q * G.K;
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < G.K; ++k) acc = fmad(m[k], v[k], acc);
      if constexpr (kDStage) acc *= dv[it][qq];
      if constexpr (kLast) {
        if (el < ne) outc[el * ND + q * G.R + r] = acc;
      } else {
        nxt[next_index(G, DIM, el, q, r)] = acc;
      }
    }
  }
  // a barrier between stages, none after the last (it writes device memory)
  if constexpr (!kLast) __syncthreads();
}

template <typename T, int DIM, int D1, int Q1, int ITD, int QGD, int... J>
__device__ __forceinline__ void stages(const Smem<T>& s, const T (&dv)[ITD][QGD],
                                       T* __restrict__ outc, int ne,
                                       std::integer_sequence<int, J...>) {
  (stage<T, DIM, D1, Q1, J, ITD, QGD>(s, dv, outc, ne), ...);
}

template <typename T, int DIM, int D1, int Q1>
__global__ void __launch_bounds__(kThreads, 2)
    mass_kernel(const T* __restrict__ u, const T* __restrict__ D, const T* __restrict__ B,
                T* __restrict__ out, int C, int NE) {
  constexpr int EPB = elems_per_block(DIM, Q1);
  constexpr int ND = ipow(D1, DIM), NQ = ipow(Q1, DIM);
  constexpr int B0 = buf_size(DIM, D1, Q1, EPB, 0), B1 = buf_size(DIM, D1, Q1, EPB, 1);
  constexpr Geo GD = geo(DIM, D1, Q1, EPB, DIM - 1);
  constexpr int ITD = cdiv(GD.items, kThreads);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<T> s = carve<T>(smem_raw, B0, B1, D1, Q1);
  const int64_t e0 = int64_t(blockIdx.x) * EPB;
  const int ne = static_cast<int>(imin(EPB, static_cast<int>(NE - e0)));
  load_tables(s, B, D1, Q1);
  // D of this thread's outputs of the D stage, for every component
  T dv[ITD][GD.QG];
  const T* De = D + e0 * NQ;
#pragma unroll
  for (int it = 0; it < ITD; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i % GD.R;
    const int grp = (i / GD.R) % GD.NG;
    const int el = i / (GD.R * GD.NG);
#pragma unroll
    for (int qq = 0; qq < GD.QG; ++qq) {
      const int q = grp * GD.QG + qq;
      dv[it][qq] = (i < GD.items && q < GD.Q && el < ne) ? De[el * NQ + q * GD.R + r] : T(0);
    }
  }
  for (int c = 0; c < C; ++c) {
    const int64_t off = (int64_t(c) * NE + e0) * ND;
    load_u(s.buf[0], u + off, ND, D1, geo(DIM, D1, Q1, EPB, 0).R, EPB, ne);
    __syncthreads();
    stages<T, DIM, D1, Q1>(s, dv, out + off, ne, std::make_integer_sequence<int, 2 * DIM>{});
  }
}

// --------------------------------------------------- runtime sizes -------
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    mass_kernel_rt(const T* __restrict__ u, const T* __restrict__ D, const T* __restrict__ B,
                   T* __restrict__ out, int C, int NE, int dim, int d1, int q1) {
  const int epb = elems_per_block(dim, q1);
  const int nd = ipow(d1, dim), nq = ipow(q1, dim);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<T> s = carve<T>(smem_raw, buf_size(dim, d1, q1, epb, 0),
                             buf_size(dim, d1, q1, epb, 1), d1, q1);
  const int64_t e0 = int64_t(blockIdx.x) * epb;
  const int ne = static_cast<int>(imin(epb, static_cast<int>(NE - e0)));
  load_tables(s, B, d1, q1);
  const T* De = D + e0 * nq;
  for (int c = 0; c < C; ++c) {
    const int64_t off = (int64_t(c) * NE + e0) * nd;
    load_u(s.buf[0], u + off, nd, d1, geo(dim, d1, q1, epb, 0).R, epb, ne);
    __syncthreads();
    for (int j = 0; j < 2 * dim; ++j) {
      const Geo g = geo(dim, d1, q1, epb, j);
      const bool dstage = j == dim - 1, last = j == 2 * dim - 1;
      const T* in = s.buf[j & 1];
      T* nxt = s.buf[(j + 1) & 1];
      const T* M = j < dim ? s.B : s.Bt;
      for (int i = threadIdx.x; i < g.items; i += kThreads) {
        const int r = i % g.R;
        const int grp = (i / g.R) % g.NG;
        const int el = i / (g.R * g.NG);
        const T* row = in + (el * g.R + r) * g.P;
        const int qend = imin(g.Q, (grp + 1) * g.QG);
        for (int q = grp * g.QG; q < qend; ++q) {
          const T* m = M + q * g.K;
          T acc = T(0);
          for (int k = 0; k < g.K; ++k) acc = fmad(m[k], row[k], acc);
          if (dstage) acc *= (el < ne ? De[int64_t(el) * nq + q * g.R + r] : T(0));
          if (last) {
            if (el < ne) out[off + int64_t(el) * nd + q * g.R + r] = acc;
          } else {
            nxt[next_index(g, dim, el, q, r)] = acc;
          }
        }
      }
      if (!last) __syncthreads();
    }
  }
}

// ------------------------------------------------------------ launch -----
template <typename T, int DIM, int D1, int Q1>
cudaError_t launch_fixed(const T* u, const T* D, const T* B, T* out, int C, int NE, int device,
                         cudaStream_t stream) {
  constexpr int EPB = elems_per_block(DIM, Q1);
  constexpr int64_t kSmem = smem_bytes(DIM, D1, Q1, sizeof(T));
  // once per device: host calls cost microseconds on a host-bound path
  static bool ready[kMaxDevices] = {};
  if (kSmem > 48 * 1024 && !ready[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        mass_kernel<T, DIM, D1, Q1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmem));
    if (err != cudaSuccess) return err;
    ready[device] = true;
  }
  const unsigned blocks = static_cast<unsigned>(cdiv(NE, EPB));
  mass_kernel<T, DIM, D1, Q1><<<blocks, kThreads, static_cast<size_t>(kSmem), stream>>>(
      u, D, B, out, C, NE);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rt(const T* u, const T* D, const T* B, T* out, int C, int NE, int dim, int d1,
                      int q1, int64_t smem, int limit, int device, cudaStream_t stream) {
  static bool ready[kMaxDevices] = {};
  if (!ready[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        mass_kernel_rt<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    if (err != cudaSuccess) return err;
    ready[device] = true;
  }
  const unsigned blocks = static_cast<unsigned>(cdiv(NE, elems_per_block(dim, q1)));
  mass_kernel_rt<T><<<blocks, kThreads, static_cast<size_t>(smem), stream>>>(u, D, B, out, C, NE,
                                                                          dim, d1, q1);
  return cudaGetLastError();
}

// (nd1, nq1) compiled with unrolled loops: L2 (k, 2k) and H1 (k + 1, 2k) of
// orders k = 1-4, 6, 8
#define MASS_SHAPES(X) \
  X(1, 2) X(2, 2) X(2, 4) X(3, 4) X(3, 6) X(4, 6) X(4, 8) X(5, 8) X(6, 12) X(7, 12) X(8, 16) X(9, 16)

template <typename T>
cudaError_t dispatch(const void* u, const void* D, const void* B, void* out, int C, int NE,
                     int dim, int d1, int q1, int64_t smem, int limit, int device, bool rt,
                     cudaStream_t stream) {
  const T* uu = static_cast<const T*>(u);
  const T* DD = static_cast<const T*>(D);
  const T* BB = static_cast<const T*>(B);
  T* oo = static_cast<T*>(out);
#define MASS_CASE(d1_, q1_)                                                              \
  if (!rt && d1 == d1_ && q1 == q1_) {                                                   \
    if (dim == 2) return launch_fixed<T, 2, d1_, q1_>(uu, DD, BB, oo, C, NE, device, stream); \
    if (dim == 3) return launch_fixed<T, 3, d1_, q1_>(uu, DD, BB, oo, C, NE, device, stream); \
  }
  MASS_SHAPES(MASS_CASE)
#undef MASS_CASE
  return launch_rt<T>(uu, DD, BB, oo, C, NE, dim, d1, q1, smem, limit, device, stream);
}

int smem_limit(int device, int* limit) {
  static int limit_of[kMaxDevices] = {};
  if (limit_of[device] == 0) {
    const cudaError_t err = cudaDeviceGetAttribute(
        &limit_of[device], cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  *limit = limit_of[device];
  return 0;
}

}  // namespace

// Plain C interface for ctypes.
//
// mass_smem_bytes: the dynamic shared memory a block of the kernel takes
// for `dim` and the table (q1, d1), in f32 (dtype 0) or f64 (dtype 1).
extern "C" int64_t mass_smem_bytes(int dtype, int dim, int d1, int q1) {
  if (dim < 1 || dim > 3 || d1 < 1 || q1 < 1 || (dtype != 0 && dtype != 1)) return -1;
  return smem_bytes(dim, d1, q1, dtype ? 8 : 4);
}

// mass_smem_limit: the shared memory a block may opt in to on `device`
// (232,448 bytes on an H100), or -1.
extern "C" int64_t mass_smem_limit(int device) {
  if (device < 0 || device >= kMaxDevices) return -1;
  int limit = 0;
  return smem_limit(device, &limit) == 0 ? limit : -1;
}

// mass_launch: out = B^T (D * (B u)) per element and component.  u, out:
// (C, NE, d1^dim), D: (NE, q1^dim), B: (q1, d1), contiguous, on `device`,
// f32 (dtype 0) or f64 (dtype 1); 1 <= dim <= 3.  Launches on `stream`
// (PyTorch's current stream), allocates nothing, does not synchronise, and
// returns cudaGetLastError() after the launch, cudaErrorInvalidValue for
// arguments outside those ranges, or kTooLarge (20001) when the block's
// shared memory (mass_smem_bytes) is above mass_smem_limit.  rt != 0 runs
// the runtime-size kernel at every size, a compiled one's too (to time the
// two against each other).
extern "C" int mass_launch(int dtype, int device, const void* u, const void* D, const void* B,
                           void* out, int64_t C, int64_t NE, int dim, int d1, int q1, int rt,
                           void* stream) {
  if (dim < 1 || dim > 3 || d1 < 1 || q1 < 1 || (dtype != 0 && dtype != 1) || C < 0 || NE < 0 ||
      C > (int64_t(1) << 30) || NE > (int64_t(1) << 30) || d1 > 64 || q1 > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int limit = 0;
  const int lerr = smem_limit(device, &limit);
  if (lerr != 0) return lerr;
  const int64_t smem = mass_smem_bytes(dtype, dim, d1, q1);
  if (smem > limit) return kTooLarge;
  if (C == 0 || NE == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Ci = static_cast<int>(C), NEi = static_cast<int>(NE);
  err = dtype ? dispatch<double>(u, D, B, out, Ci, NEi, dim, d1, q1, smem, limit, device, rt, s)
              : dispatch<float>(u, D, B, out, Ci, NEi, dim, d1, q1, smem, limit, device, rt, s);
  return static_cast<int>(err);
}
