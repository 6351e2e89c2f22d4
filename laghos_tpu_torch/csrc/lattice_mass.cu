// Lattice H1 partial-assembly mass apply for Hopper (sm_90a).
//
// Computes, for every component c of the raster H1 L-vector u (C, Lz, Ly,
// Lx), L = n p + 1 nodes an axis,
//   y[c] = Tz' Ty' Tx' ( D * Tx Ty Tz u[c] )
// with the banded tables T (L, n nq1) of one 1D table B (nq1, p + 1) and
// the q-lattice weights D (Qz, Qy, Qx), Q = n nq1: the velocity CG's
// operator on every lattice path (the reference's MassPAOperator,
// laghos_assembly.cpp:80-121).  Replaces laghos_tpu/ops/lattice.py::
// mass_apply_lattice, which the JAX package leaves to XLA (no Pallas
// kernel): there 2 dim dense tensordots against the banded tables, and in
// the port's plain twin (laghos_tpu_torch/ops/lattice.py::
// mass_apply_lattice_plain) the same torch.tensordot calls with a movedim
// copy after each, about 14 launches an apply.  Each column of a banded
// table has p + 1 nonzeros of its L, so the dense chain multiplies mostly
// by zero: at Q8-Q7 (L 129, Q 256, C 3) it does 22.8 G multiply-adds where
// the sum factorisation does 1.70 G.
//
// Design: element by element, as MFEM's SmemPAMassApply3D, then a fixed
// order assembly, in two kernels on the caller's stream:
//  * lattice_mass_stages runs csrc/mass.cu's element apply (mass_core.cuh:
//    the same stages, FMA chains and persistent blocks) with LatSrc: each
//    element copies its (p + 1)^dim dofs straight from the lattice at
//    strides (dof (a, b, c) of element (ez, ey, ex) is node (ez p + a, ey p
//    + b, ex p + c)) and its q-points from the q-lattice, and writes its
//    outputs to an E-vector (C, NE, (p + 1)^dim);
//  * lattice_mass_assemble gives each node the sum of its 1 to 2^dim
//    element contributions, in a fixed order (along each axis the lower
//    element first, z outermost), so no atomics are needed and two
//    launches on the same input give the same bits.
// The element route sums in another order than the twin's GEMMs: results
// agree at round-off (1e-13 x max in f64), not bit for bit.
//
// What bounds it: the least traffic is u and D read once and y written
// once (237 MB at Q8-Q7 in f64: 71 us at 3.35 TB/s); the element apply
// does 1.70 G FMAs there, about 0.24 ms of stages at Q8-Q7 f64, and the
// E-vector adds 2 x 72 MB of traffic between the two kernels.  The table
// is a kernel parameter read inside each output's loop and the C
// components run one after another, so that instance issues about one
// ULDC per DFMA.  A redesign was measured on the H100 and lost (PERF.md
// §6): bricks of elements with all C components in one pass (half the
// table loads), summed in shared memory with a face buffer between
// bricks, kept these bits but ran slower.  At Q8-Q7 its shared memory
// left one block an SM, so copies, assembly and barriers no longer hid
// under a second block's FMAs, and its stages alone were no faster than
// these; at Q2-Q4 the on-chip sums cost as much as the stages.  FP64
// tensor-core stages are the next lever (they reorder the chains: the
// bits move).
//
// The element sizes of the H1 tables of orders 1-4, 6 and 8 ((k + 1, 2k))
// in 2D and 3D run compiled instances; every other size, and 1D, the
// runtime-size body.  No fast math.

#include "mass_core.cuh"

namespace {

constexpr int kAsmThreads = 256;

template <typename T, int DIM, int D1, int Q1>
__global__ void __launch_bounds__(kThreads, 2)
    lattice_mass_stages(const __grid_constant__ LatSrc<T> src, T* __restrict__ out, int C, int NE,
                        const __grid_constant__ Table<T, D1 * Q1> tab) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  mass_body<T, DIM, D1, Q1>(src, out, C, NE, tab, reinterpret_cast<T*>(smem_raw));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    lattice_mass_stages_rt(const __grid_constant__ LatSrc<T> src, const T* __restrict__ B,
                           T* __restrict__ out, int C, int NE, int dim, int d1, int q1) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  mass_body_rt<T>(src, B, out, C, NE, dim, d1, q1, smem_raw);
}

// The elements (e, local node a) holding node i of an axis of n elements
// of order p, the lower element first: one, or two where i is an interior
// element boundary.
__device__ __forceinline__ int holders(int i, int p, int n, int* e, int* a) {
  const int hi = imin(i / p, n - 1), ai = i - hi * p;
  if (ai == 0 && hi > 0) {
    e[0] = hi - 1;
    a[0] = p;
    e[1] = hi;
    a[1] = 0;
    return 2;
  }
  e[0] = hi;
  a[0] = ai;
  return 1;
}

// y (C, Lz, Ly, Lx) from the E-vector ye (C, NE, nd), nd = d1^dim: each
// node the sum of its holders' values, z pairs outermost, x innermost, the
// first value taken as it is.  Missing axes have n = 1 and L = 1.  I: the
// index type, 32-bit unsigned where every index fits (an int64 division
// takes several times the instructions of a 32-bit one).
template <typename T, typename I>
__global__ void __launch_bounds__(kAsmThreads)
    lattice_mass_assemble(const T* __restrict__ ye, T* __restrict__ y, I total, int NE, int nd,
                          int d1, int nx, int ny, int nz, int Lx, int Ly, int Lz) {
  const int p = d1 - 1;
  for (I i = blockIdx.x * I(kAsmThreads) + threadIdx.x; i < total;
       i += I(gridDim.x) * kAsmThreads) {
    const I r = i / I(Lx), s = r / I(Ly), c = s / I(Lz);
    const int ix = int(i - r * I(Lx)), iy = int(r - s * I(Ly)), iz = int(s - c * I(Lz));
    int ex[2], ax[2], ey[2], ay[2], ez[2], az[2];
    const int mx = holders(ix, p, nx, ex, ax);
    const int my = holders(iy, p, ny, ey, ay);
    const int mz = holders(iz, p, nz, ez, az);
    const T* yc = ye + c * I(NE) * I(nd);
    T acc = T(0);
    bool first = true;
    for (int a = 0; a < mz; ++a) {
      for (int b = 0; b < my; ++b) {
        for (int k = 0; k < mx; ++k) {
          const I e = (I(ez[a]) * ny + ey[b]) * nx + ex[k];
          const T v = yc[e * nd + (az[a] * d1 + ay[b]) * d1 + ax[k]];
          acc = first ? v : acc + v;
          first = false;
        }
      }
    }
    y[i] = acc;
  }
}

// (nd1, nq1) compiled with unrolled loops: the H1 tables (k + 1, 2k) of
// orders k = 1-4, 6, 8
#define LATTICE_SHAPES(X) X(2, 2) X(3, 4) X(4, 6) X(5, 8) X(7, 12) X(9, 16)

template <typename T, int DIM, int D1, int Q1>
cudaError_t launch_fixed(const LatSrc<T>& src, const T* table, T* ye, int C, int NE, int device,
                         cudaStream_t stream) {
  constexpr int EPB = elems_per_block(DIM, Q1);
  constexpr int64_t kSmem = int64_t(LayoutOf<T, DIM, D1, Q1>::total) * int64_t(sizeof(T));
  static int slots[kMaxDevices] = {};
  int grid = 0;
  const cudaError_t err =
      resident_grid(lattice_mass_stages<T, DIM, D1, Q1>, kSmem, device, slots, &grid);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(imin(cdiv(NE, EPB), grid));
  Table<T, D1 * Q1> tab;
  for (int i = 0; i < D1 * Q1; ++i) tab.v[i] = table[i];
  lattice_mass_stages<T, DIM, D1, Q1><<<blocks, kThreads, static_cast<size_t>(kSmem), stream>>>(
      src, ye, C, NE, tab);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rt(const LatSrc<T>& src, const T* B, T* ye, int C, int NE, int dim, int d1,
                      int q1, int64_t smem, int limit, int device, cudaStream_t stream) {
  static bool ready[kMaxDevices] = {};
  if (!ready[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        lattice_mass_stages_rt<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    if (err != cudaSuccess) return err;
    ready[device] = true;
  }
  const unsigned blocks = static_cast<unsigned>(cdiv(NE, elems_per_block(dim, q1)));
  lattice_mass_stages_rt<T><<<blocks, kThreads, static_cast<size_t>(smem), stream>>>(
      src, B, ye, C, NE, dim, d1, q1);
  return cudaGetLastError();
}

// the shared memory a block of the compiled instance for (dim, d1, q1)
// takes, or -1 where none is compiled
template <typename T>
int64_t fixed_smem(int dim, int d1, int q1) {
#define LAT_BYTES(d1_, q1_)                                                              \
  if (d1 == d1_ && q1 == q1_) {                                                          \
    if (dim == 2) return int64_t(LayoutOf<T, 2, d1_, q1_>::total) * int64_t(sizeof(T));  \
    if (dim == 3) return int64_t(LayoutOf<T, 3, d1_, q1_>::total) * int64_t(sizeof(T));  \
  }
  LATTICE_SHAPES(LAT_BYTES)
#undef LAT_BYTES
  return -1;
}

template <typename T>
cudaError_t apply(const void* u, const void* D, const void* B, const void* table, void* ye,
                  void* y, int C, int dim, int d1, int q1, int nx, int ny, int nz, int64_t smem,
                  int limit, int device, bool rt, cudaStream_t stream) {
  const int p = d1 - 1, NE = nx * ny * nz;
  const int Lx = nx * p + 1, Ly = dim > 1 ? ny * p + 1 : 1, Lz = dim > 2 ? nz * p + 1 : 1;
  const int64_t Qx = int64_t(nx) * q1, Qy = dim > 1 ? int64_t(ny) * q1 : 1;
  LatSrc<T> src;
  src.u = static_cast<const T*>(u);
  src.D = static_cast<const T*>(D);
  src.nx = static_cast<unsigned>(nx);
  src.ny = static_cast<unsigned>(ny);
  src.sy = Lx;
  src.sz = int64_t(Lx) * Ly;
  src.sc = src.sz * Lz;
  src.qy = Qx;
  src.qz = Qx * Qy;
  src.vec = (reinterpret_cast<uintptr_t>(D) % 16 == 0 && Qx * int64_t(sizeof(T)) % 16 == 0) << 1;
  const T* tt = static_cast<const T*>(table);
  T* e = static_cast<T*>(ye);
  cudaError_t err = cudaErrorNotYetImplemented;
  bool done = false;
#define LAT_CASE(d1_, q1_)                                                           \
  if (!done && !rt && d1 == d1_ && q1 == q1_ && (dim == 2 || dim == 3)) {            \
    if (tt == nullptr) return cudaErrorInvalidValue;                                 \
    err = dim == 2 ? launch_fixed<T, 2, d1_, q1_>(src, tt, e, C, NE, device, stream) \
                   : launch_fixed<T, 3, d1_, q1_>(src, tt, e, C, NE, device, stream); \
    done = true;                                                                     \
  }
  LATTICE_SHAPES(LAT_CASE)
#undef LAT_CASE
  if (!done) {
    err = launch_rt<T>(src, static_cast<const T*>(B), e, C, NE, dim, d1, q1, smem, limit, device,
                       stream);
  }
  if (err != cudaSuccess) return err;
  // a thread a node, at most 8 blocks an SM walking the rest
  const int64_t total = int64_t(C) * Lz * Ly * Lx;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t want = (total + kAsmThreads - 1) / kAsmThreads;
  const unsigned blocks = static_cast<unsigned>(want < 8 * sms ? want : 8 * sms);
  const int nd = ipow(d1, dim);
  // 32-bit indices where the E-vector and the lattice, and a grid stride
  // past their ends, stay below 2^32
  const int64_t span = int64_t(C) * NE * nd + int64_t(blocks) * kAsmThreads;
  if (span < (int64_t(1) << 32) && total + int64_t(blocks) * kAsmThreads < (int64_t(1) << 32)) {
    lattice_mass_assemble<T, uint32_t><<<blocks, kAsmThreads, 0, stream>>>(
        e, static_cast<T*>(y), static_cast<uint32_t>(total), NE, nd, d1, nx, ny, nz, Lx, Ly, Lz);
  } else {
    lattice_mass_assemble<T, int64_t><<<blocks, kAsmThreads, 0, stream>>>(
        e, static_cast<T*>(y), total, NE, nd, d1, nx, ny, nz, Lx, Ly, Lz);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.
//
// lattice_mass_launch: y[c] = Tz' Ty' Tx' (D * Tx Ty Tz u[c]) on the raster
// lattice of nx x ny x nz elements of order p = d1 - 1 (ny = nz = 1 in 1D,
// nz = 1 in 2D): u, y (C, Lz, Ly, Lx) with L = n p + 1, D the q-lattice
// (Qz, Qy, Qx) with Q = n q1, B the 1D table (q1, d1), ye scratch for the
// E-vector (C, nx ny nz, d1^dim); contiguous, on `device`, f32 (dtype 0) or
// f64 (dtype 1).  `table`: B's values in host memory (read by the compiled
// instances, which take it as a kernel parameter; may be null with rt or
// at a size none is compiled for).  Launches the element stages, then the
// assembly, on `stream`; allocates nothing, does not synchronise, and
// returns cudaGetLastError() after the launches, cudaErrorInvalidValue for
// arguments outside those ranges, or 20001 when a block's shared memory
// (mass_smem_bytes) is above mass_smem_limit.  rt != 0 runs the
// runtime-size body at every size (to time the two against each other).
extern "C" int lattice_mass_launch(int dtype, int device, const void* u, const void* D,
                                   const void* B, const void* table, void* ye, void* y, int64_t C,
                                   int dim, int d1, int q1, int64_t nx, int64_t ny, int64_t nz,
                                   int rt, void* stream) {
  const int64_t ne = nx * ny * nz;
  if (dim < 1 || dim > 3 || d1 < 2 || q1 < 1 || d1 > 64 || q1 > 64 ||
      (dtype != 0 && dtype != 1) || C < 0 || C > (int64_t(1) << 30) || nx < 1 || ny < 1 ||
      nz < 1 || (dim < 3 && nz != 1) || (dim < 2 && ny != 1) || nx > (int64_t(1) << 20) ||
      ny > (int64_t(1) << 20) || nz > (int64_t(1) << 20) || ne > (int64_t(1) << 30) ||
      C * ne * ipow(d1, dim) > (int64_t(1) << 40)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int limit = 0;
  const int lerr = smem_limit(device, &limit);
  if (lerr != 0) return lerr;
  const int size = dtype ? 8 : 4;
  const int64_t fixed = rt ? -1 : dtype ? fixed_smem<double>(dim, d1, q1)
                                        : fixed_smem<float>(dim, d1, q1);
  const int64_t smem = fixed > 0 ? fixed : smem_bytes(dim, d1, q1, size);
  if (smem > limit) return kTooLarge;
  if (C == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Ci = static_cast<int>(C), x = static_cast<int>(nx), yy = static_cast<int>(ny),
            z = static_cast<int>(nz);
  err = dtype ? apply<double>(u, D, B, table, ye, y, Ci, dim, d1, q1, x, yy, z, smem, limit,
                              device, rt != 0, s)
              : apply<float>(u, D, B, table, ye, y, Ci, dim, d1, q1, x, yy, z, smem, limit,
                             device, rt != 0, s);
  return static_cast<int>(err);
}
