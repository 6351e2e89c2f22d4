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
// of bytes at 3.35 TB/s against 28 us of FP64 FMA outside the tensor cores
// (the kernel keeps IEEE FMA chains in the reference order, so no DMMA), so
// bytes bound it, D being 134 MB of the 168.  The H1 apply (nd1 9, C 3)
// does 3.6x the FMAs on 1.7x the bytes: ~110 us of FP64 FMA against 83 us
// of bytes.
//
// The first design (one block an element, the table row of each output
// read from shared memory) ran at 19-34 % of that bound on an H100: ptxas
// gave its q8 f64 instances 0.66-0.68 LDS a DFMA (static SASS: L2 296 LDS,
// 448 DFMA; H1 485, 712), so the shared-memory pipe paced the stages, and D
// waited for its element.  This one:
//  * takes the table as a kernel parameter: every thread reads a table
//    value at the same address at the same time, so it comes from the
//    constant cache as an operand of the FMA (a ULDC into a uniform
//    register), with no register or shared-memory load; a thread then runs
//    all the outputs of its group (TQ of them, warp-uniform) for its rows,
//    and reads each row once with 16-byte loads (0.13 LDS a DFMA in the
//    q8 L2 f64 instance's static SASS, 0.08 at H1);
//  * runs persistent blocks, as many as the card holds (two an SM at q8),
//    each walking groups of elements; while the stages of one task (a
//    group and component) run, cp.async brings in the next task's u and
//    the next group's D, so the byte stream runs under the arithmetic;
//  * splits a stage with few rows among NG warp-uniform groups of threads,
//    each taking TQ of the Q outputs, so every stage keeps the threads busy
//    (at q8 L2 every thread runs one row of every stage);
//  * computes each thread's offsets once a stage: the row step is chosen at
//    compile time so every later row is the first plus a constant.
// What bounds it now: the FP64 FMAs and their table operands.  Each FMA
// takes its own table value (one ULDC a DFMA), so the issue slots of an
// SM sub-partition run about as full as its FP64 pipe; at q8 L2 the byte
// stream and the arithmetic overlap (70 % of the byte bound), at q8 H1 the
// issue of the FMA and table-operand pairs bounds it (36 %).
//
// Layout: each contraction takes the fastest axis of its input and puts its
// new axis slowest (u[z][y][x] -> [qx][z][y] -> [qy][qx][z] -> [qz][qy][qx]),
// so after dim contractions the axes are back in order: every stage reads
// rows of K contiguous values and the D product and the final store index
// the output flat, as D and out are laid out.  A stage's rows lie at a
// stride of an odd number of 16-byte vectors, so the 8 rows a quarter warp
// loads fall in distinct bank groups.  Each output is one fused
// multiply-add chain over its K inputs in ascending order, D multiplying
// the last forward sum after it: no atomics, no order that depends on
// timing, and in f64 the same bits as the first design and the plain twin.
//
// The sizes (nd1, nq1) of orders 1-4, 6 and 8 (L2 (k, 2k) and H1
// (k + 1, 2k)) in 2D and 3D are compiled with their loops unrolled; any
// other size, and every 1D size, runs one runtime-size kernel with the
// first design's layout (its products read the table from shared memory,
// and it reads D at the D stage of each component), a block a group of
// elements.  Both take their shared memory dynamically, above 48 KB after
// cudaFuncSetAttribute: the compiled instances the first stage's input,
// D and two buffers (95,232 bytes at Q8-Q7 L2 and 96,848 at H1 in f64), the
// runtime-size kernel two buffers and the table twice.  A runtime size whose
// buffers exceed the card's opt-in limit (232,448 bytes on an H100) is
// refused (kTooLarge) and raised by the wrapper; in 3D f64 the largest
// order that fits is -ok 12 (H1 (13, 24): 182,592 bytes; -ok 13's H1
// (14, 26) needs 232,960).
//
// The device code (the stages, the persistent body and the runtime-size
// body) is in mass_core.cuh, which csrc/lattice_mass.cu shares: there the
// elements read their u and D from the raster lattice.
//
// No fast math: IEEE multiply/add, no flush to zero.

#include "mass_core.cuh"

namespace {

template <typename T, int DIM, int D1, int Q1>
__global__ void __launch_bounds__(kThreads, 2)
    mass_kernel(const T* __restrict__ u, const T* __restrict__ D, T* __restrict__ out, int C,
                int NE, int vec, const __grid_constant__ Table<T, D1 * Q1> tab) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  mass_body<T, DIM, D1, Q1>(ElemSrc<T>{u, D, NE, vec}, out, C, NE, tab,
                            reinterpret_cast<T*>(smem_raw));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    mass_kernel_rt(const T* __restrict__ u, const T* __restrict__ D, const T* __restrict__ B,
                   T* __restrict__ out, int C, int NE, int dim, int d1, int q1) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  mass_body_rt<T>(ElemSrc<T>{u, D, NE, 0}, B, out, C, NE, dim, d1, q1, smem_raw);
}

// ------------------------------------------------------------ launch -----
template <typename T, int DIM, int D1, int Q1>
cudaError_t grid_of(int device, int* grid) {
  constexpr int64_t kSmem = int64_t(LayoutOf<T, DIM, D1, Q1>::total) * int64_t(sizeof(T));
  static int slots[kMaxDevices] = {};
  return resident_grid(mass_kernel<T, DIM, D1, Q1>, kSmem, device, slots, grid);
}

template <typename T, int DIM, int D1, int Q1>
cudaError_t launch_fixed(const T* u, const T* D, const T* table, T* out, int C, int NE,
                         int device, cudaStream_t stream) {
  constexpr int EPB = elems_per_block(DIM, Q1);
  constexpr int64_t kSmem = int64_t(LayoutOf<T, DIM, D1, Q1>::total) * int64_t(sizeof(T));
  int grid = 0;
  const cudaError_t err = grid_of<T, DIM, D1, Q1>(device, &grid);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(imin(cdiv(NE, EPB), grid));
  const int vec = int(reinterpret_cast<uintptr_t>(u) % 16 == 0) |
                  int(reinterpret_cast<uintptr_t>(D) % 16 == 0) << 1;
  Table<T, D1 * Q1> tab;
  for (int i = 0; i < D1 * Q1; ++i) tab.v[i] = table[i];
  mass_kernel<T, DIM, D1, Q1><<<blocks, kThreads, static_cast<size_t>(kSmem), stream>>>(
      u, D, out, C, NE, vec, tab);
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
cudaError_t dispatch(const void* u, const void* D, const void* B, const void* table, void* out,
                     int C, int NE, int dim, int d1, int q1, int64_t smem, int limit, int device,
                     bool rt, cudaStream_t stream) {
  const T* uu = static_cast<const T*>(u);
  const T* DD = static_cast<const T*>(D);
  const T* BB = static_cast<const T*>(B);
  const T* tt = static_cast<const T*>(table);
  T* oo = static_cast<T*>(out);
#define MASS_CASE(d1_, q1_)                                                                   \
  if (!rt && d1 == d1_ && q1 == q1_) {                                                        \
    if (tt == nullptr) return cudaErrorInvalidValue;                                          \
    if (dim == 2) return launch_fixed<T, 2, d1_, q1_>(uu, DD, tt, oo, C, NE, device, stream); \
    if (dim == 3) return launch_fixed<T, 3, d1_, q1_>(uu, DD, tt, oo, C, NE, device, stream); \
  }
  MASS_SHAPES(MASS_CASE)
#undef MASS_CASE
  return launch_rt<T>(uu, DD, BB, oo, C, NE, dim, d1, q1, smem, limit, device, stream);
}

// the shared memory a block of the compiled instance for (dim, d1, q1)
// takes, or -1 where none is compiled
template <typename T>
int64_t fixed_smem(int dim, int d1, int q1) {
#define MASS_BYTES(d1_, q1_)                                                             \
  if (d1 == d1_ && q1 == q1_) {                                                          \
    if (dim == 2) return int64_t(LayoutOf<T, 2, d1_, q1_>::total) * int64_t(sizeof(T));  \
    if (dim == 3) return int64_t(LayoutOf<T, 3, d1_, q1_>::total) * int64_t(sizeof(T));  \
  }
  MASS_SHAPES(MASS_BYTES)
#undef MASS_BYTES
  return -1;
}

// the grid of the compiled instance for (dim, d1, q1) on `device`, or 0
// where none is compiled
template <typename T>
cudaError_t fixed_grid(int device, int dim, int d1, int q1, int* grid) {
  *grid = 0;
#define MASS_GRID(d1_, q1_)                                                       \
  if (d1 == d1_ && q1 == q1_) {                                                   \
    if (dim == 2) return grid_of<T, 2, d1_, q1_>(device, grid);                    \
    if (dim == 3) return grid_of<T, 3, d1_, q1_>(device, grid);                    \
  }
  MASS_SHAPES(MASS_GRID)
#undef MASS_GRID
  return cudaSuccess;
}

}  // namespace

// Plain C interface for ctypes.
//
// mass_smem_bytes: the dynamic shared memory a block takes for `dim` and
// the table (q1, d1), in f32 (dtype 0) or f64 (dtype 1): the compiled
// instance's where one is compiled, else the runtime-size kernel's.
extern "C" int64_t mass_smem_bytes(int dtype, int dim, int d1, int q1) {
  if (dim < 1 || dim > 3 || d1 < 1 || q1 < 1 || (dtype != 0 && dtype != 1)) return -1;
  const int64_t fixed = dtype ? fixed_smem<double>(dim, d1, q1) : fixed_smem<float>(dim, d1, q1);
  return fixed > 0 ? fixed : smem_bytes(dim, d1, q1, dtype ? 8 : 4);
}

// mass_smem_limit: the shared memory a block may opt in to on `device`
// (232,448 bytes on an H100), or -1.
extern "C" int64_t mass_smem_limit(int device) {
  if (device < 0 || device >= kMaxDevices) return -1;
  int limit = 0;
  return smem_limit(device, &limit) == 0 ? limit : -1;
}

// mass_grid: the blocks the compiled instance for (dim, d1, q1) launches
// at most on `device` (each walks groups of elements until none is left),
// 0 where none is compiled, or a negative CUDA error.
extern "C" int64_t mass_grid(int dtype, int device, int dim, int d1, int q1) {
  if (device < 0 || device >= kMaxDevices || (dtype != 0 && dtype != 1)) return -1;
  cudaError_t err = cudaSetDevice(device);
  int grid = 0;
  if (err == cudaSuccess) {
    err = dtype ? fixed_grid<double>(device, dim, d1, q1, &grid)
                : fixed_grid<float>(device, dim, d1, q1, &grid);
  }
  return err == cudaSuccess ? grid : -static_cast<int64_t>(err);
}

// mass_launch: out = B^T (D * (B u)) per element and component.  u, out:
// (C, NE, d1^dim), D: (NE, q1^dim), B: (q1, d1), contiguous, on `device`,
// f32 (dtype 0) or f64 (dtype 1); 1 <= dim <= 3; `table` the values of B
// in host memory (read by the compiled instances, which take the table as
// a kernel parameter; may be null with rt or at a size none is compiled
// for, and is cudaErrorInvalidValue where one runs).  Launches on `stream`
// (PyTorch's current stream), allocates nothing, does not synchronise, and
// returns cudaGetLastError() after the launch, cudaErrorInvalidValue for
// arguments outside those ranges, or kTooLarge (20001) when the block's
// shared memory (mass_smem_bytes) is above mass_smem_limit.  rt != 0 runs
// the runtime-size kernel at every size, a compiled one's too (to time the
// two against each other).
extern "C" int mass_launch(int dtype, int device, const void* u, const void* D, const void* B,
                           const void* table, void* out, int64_t C, int64_t NE, int dim, int d1,
                           int q1, int rt, void* stream) {
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
  const int64_t smem =
      rt ? smem_bytes(dim, d1, q1, dtype ? 8 : 4) : mass_smem_bytes(dtype, dim, d1, q1);
  if (smem > limit) return kTooLarge;
  if (C == 0 || NE == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Ci = static_cast<int>(C), NEi = static_cast<int>(NE);
  err = dtype ? dispatch<double>(u, D, B, table, out, Ci, NEi, dim, d1, q1, smem, limit, device,
                                 rt, s)
              : dispatch<float>(u, D, B, table, out, Ci, NEi, dim, d1, q1, smem, limit, device, rt,
                                s);
  return static_cast<int>(err);
}
