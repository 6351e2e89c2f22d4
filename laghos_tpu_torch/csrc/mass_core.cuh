// Device code of the element partial-assembly mass apply, shared by
// csrc/mass.cu (elements of an E-vector: ops/mass.mass_apply_e) and
// csrc/lattice_mass.cu (elements of the raster H1 lattice:
// ops/lattice.mass_apply_lattice).  csrc/mass.cu's header says what it
// computes, what bounds it and how the compiled instances are laid out.
//
// The two differ only in where a block finds an element's u and D: a
// source (ElemSrc, LatSrc) copies them into shared memory (the compiled
// instances, `mass_body`) or reads them (the runtime-size kernel,
// `mass_body_rt`); the stages, their FMA chains and the E-vector they
// write are the same code.

#pragma once

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


// component c's dof values of the block's elements (the first e0) into
// buffer 0, as rows of nd1 at stride odd(nd1), read from `src`; elements
// past NE read as 0
template <typename T, class Src>
__device__ __forceinline__ void load_u(T* __restrict__ dst, const Src& src, int c, int64_t e0,
                                       int nd, int d1, int R0, int epb, int ne) {
  const int P0 = odd(d1);
  for (int f = threadIdx.x; f < epb * nd; f += kThreads) {
    const int el = f / nd, rem = f - el * nd;
    const int r = rem / d1, k = rem - r * d1;
    dst[(el * R0 + r) * P0 + k] = el < ne ? src.u_at(c, e0 + el, rem, d1, nd) : T(0);
  }
}


// ------------------------------------------------- compiled sizes --------
// rows a stage wants for every thread to take a row of its own; a stage
// with fewer splits its outputs among NG groups of threads instead
constexpr int kRowsFull = kThreads;

// The 1D table B (q1 rows of d1) of a compiled instance, passed by value:
// the kernel's parameters live in a constant bank, and every thread reads a
// table value at the same address at the same time, so it reaches the FMA
// from the constant cache through a uniform register (one ULDC; no vector
// register, no shared-memory load).
template <typename T, int N>
struct Table {
  T v[N];
};

template <typename T>
struct Vec16;
template <>
struct Vec16<double> {
  using type = double2;
};
template <>
struct Vec16<float> {
  using type = float4;
};

// values of T in a 16-byte vector
template <typename T>
__host__ __device__ constexpr int vlen() {
  return 16 / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ double part(const double2& x, int w) { return w == 0 ? x.x : x.y; }
__device__ __forceinline__ float part(const float4& x, int w) {
  return w == 0 ? x.x : w == 1 ? x.y : w == 2 ? x.z : x.w;
}

// a row stride for K values: an odd number of 16-byte vectors, so the
// rows a quarter warp reads at once fall in distinct 16-byte bank groups
__host__ __device__ constexpr int pstride(int k, int v) { return (cdiv(k, v) | 1) * v; }

// Stage j of 2 dim as the compiled instances run it (K, Q, R and Bn as in
// Geo).  The block's threads form NG groups of TG (whole warps when NG >
// 1); group g takes outputs g TQ, ..., g TQ + TQ - 1 of every row, and its
// thread rho0 takes rows rho0, rho0 + TG, ... (TR of them, run together:
// each table value it reads serves TR FMAs) of the group's EPB R rows (rho
// = el R + r).  Row rho of the stage's input lies at rho P: rows of K
// values at stride P, with no padding between blocks or elements (the
// lanes of a warp take consecutive rows, which then lie at the one stride
// P).  AFF: every output offset of row rho0 + i TG is row rho0's plus that
// of row i TG (see out_row), so a thread computes its offsets once a
// stage and adds constants.
struct Stage {
  int K, Q, R, Bn;
  int TQ, NG, TG, TR;
  int P;
  int AFF;
};

// Offsets (in values) of row rho of a stage of Q outputs a row: the row
// its outputs go to in the next stage's input (rows of stride P), less the
// output's block (out_row: output q of row (el, r) goes to row (el, q,
// r / Bn), column r % Bn), and the row of D or of out it reads or writes,
// less the output's block (flat_row: flat element data of es values).
__host__ __device__ constexpr unsigned out_row(unsigned rho, unsigned R, unsigned Bn, unsigned Q,
                                               unsigned P) {
  return rho / R * (Q * (R / Bn) * P) + rho % R / Bn * P + rho % R % Bn;
}
__host__ __device__ constexpr unsigned flat_row(unsigned rho, unsigned R, unsigned es) {
  return rho / R * es + rho % R;
}

// Where a compiled instance keeps things in shared memory (offsets and
// sizes in values of T): the first stage's input (the group's u of one
// component), D of the group (as in device memory), and two buffers for
// the inputs of the later stages (odd j in buf0, even j in buf1).
struct Layout {
  Stage st[6];
  int ubuf, dbuf, buf0, buf1, total;
};

// whether stage j of L (its input and output layouts final) is AFF at row
// step tg
__host__ __device__ constexpr bool affine(const Layout& L, int dim, int j, int tg, int epb,
                                          int nd) {
  const Stage& s = L.st[j];
  const int np = L.st[j + 1 < 2 * dim ? j + 1 : j].P, nq = s.Q * s.R;
  const int rows = epb * s.R;
  for (int rho0 = 0; rho0 < tg; ++rho0) {
    for (int rho = rho0 + tg; rho < rows; rho += tg) {
      const int i = rho - rho0;
      const bool out = j == 2 * dim - 1
                           ? flat_row(rho, s.R, nd) == flat_row(rho0, s.R, nd) + flat_row(i, s.R, nd)
                           : out_row(rho, s.R, s.Bn, s.Q, np) ==
                                 out_row(rho0, s.R, s.Bn, s.Q, np) + out_row(i, s.R, s.Bn, s.Q, np);
      const bool d = j != dim - 1 ||
                     flat_row(rho, s.R, nq) == flat_row(rho0, s.R, nq) + flat_row(i, s.R, nq);
      if (!(out && d)) return false;
    }
  }
  return true;
}

// The layout of a compiled instance.  NG: 1 for a stage of at least
// kRowsFull rows, else the power of two (at most 4, no group without an
// output) that brings its rows nearest kRowsFull.
template <typename T>
__host__ __device__ constexpr Layout make_layout(int dim, int d1, int q1) {
  constexpr int V = vlen<T>();
  const int epb = elems_per_block(dim, q1);
  Layout L{};
  for (int j = 0; j < 2 * dim; ++j) {
    const bool fwd = j < dim;
    const int a = fwd ? j : j - dim;
    Stage& s = L.st[j];
    s.K = fwd ? d1 : q1;
    s.Q = fwd ? q1 : d1;
    s.R = fwd ? ipow(q1, a) * ipow(d1, dim - 1 - a) : ipow(d1, a) * ipow(q1, dim - 1 - a);
    s.Bn = a < dim - 1 ? s.K : q1;
    s.NG = 1;
    while (s.NG < 4 && 2 * s.NG * epb * s.R <= kRowsFull &&
           (2 * s.NG - 1) * cdiv(s.Q, 2 * s.NG) < s.Q) {
      s.NG *= 2;  // every group keeps an output
    }
    s.TQ = cdiv(s.Q, s.NG);
    s.TG = kThreads / s.NG;
    s.P = pstride(s.K, V);
  }
  // each stage's row step: with one group, the largest at most kThreads
  // (so no more rows a thread) at which it is AFF; with more, TG (whole
  // warps a group)
  for (int j = 0; j < 2 * dim; ++j) {
    Stage& s = L.st[j];
    const int rows = epb * s.R, tg0 = s.TG;
    for (int tg = tg0; tg > 0 && cdiv(rows, tg) == cdiv(rows, tg0); --tg) {
      if (affine(L, dim, j, tg, epb, ipow(d1, dim))) {
        s.TG = tg;
        s.AFF = 1;
        break;
      }
      if (s.NG > 1) break;
    }
    s.TR = cdiv(rows, s.TG);
  }
  int b0 = 0, b1 = 0;
  for (int j = 1; j < 2 * dim; ++j) {
    if (j & 1) {
      b0 = imax(b0, epb * L.st[j].R * L.st[j].P);
    } else {
      b1 = imax(b1, epb * L.st[j].R * L.st[j].P);
    }
  }
  L.ubuf = 0;
  L.dbuf = L.ubuf + epb * L.st[0].R * L.st[0].P;
  L.buf0 = L.dbuf + cdiv(epb * ipow(q1, dim), V) * V;
  L.buf1 = L.buf0 + b0;
  L.total = L.buf1 + b1;
  return L;
}

// The layout's numbers as compile-time scalars (device code reads only
// scalars of a constexpr host variable).
template <typename T, int DIM, int D1, int Q1>
struct LayoutOf {
  static constexpr Layout L = make_layout<T>(DIM, D1, Q1);
  static constexpr int ubuf = L.ubuf, dbuf = L.dbuf, buf0 = L.buf0, buf1 = L.buf1, total = L.total;
};

template <typename T, int DIM, int D1, int Q1, int J>
struct StageOf {
  static constexpr Stage S = LayoutOf<T, DIM, D1, Q1>::L.st[J];
  static constexpr int K = S.K, Q = S.Q, R = S.R, Bn = S.Bn;
  static constexpr int TQ = S.TQ, NG = S.NG, TG = S.TG, TR = S.TR, P = S.P;
  static constexpr bool AFF = S.AFF != 0;
};

template <int B>
__device__ __forceinline__ void cp_async(void* smem_dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  if constexpr (B == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(B)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One component's u of the group's ne elements (src: the first's) into the
// first stage's rows, with cp.async: 16-byte pieces when vec (src aligned)
// and rows are whole vectors, else one value a copy.
template <typename T, int DIM, int D1, int Q1>
__device__ __forceinline__ void fetch_u_flat(T* dst, const T* __restrict__ src, unsigned ne, bool vec) {
  constexpr unsigned ND = ipow(D1, DIM), V = vlen<T>(), P = StageOf<T, DIM, D1, Q1, 0>::P;
  // value f of the group's u: row f / D1, column f % D1
  if constexpr (D1 % V == 0) {
    if (vec) {
      for (unsigned f = threadIdx.x * V; f < ne * ND; f += kThreads * V) {
        cp_async<16>(dst + f / D1 * P + f % D1, src + f);
      }
      return;
    }
  }
  for (unsigned f = threadIdx.x; f < ne * ND; f += kThreads) {
    cp_async<sizeof(T)>(dst + f / D1 * P + f % D1, src + f);
  }
}

// D of the group's ne elements (src: the first's), likewise, as it lies
template <typename T, int DIM, int D1, int Q1>
__device__ __forceinline__ void fetch_d_flat(T* dst, const T* __restrict__ src, unsigned ne, bool vec) {
  constexpr unsigned NQ = ipow(Q1, DIM), V = vlen<T>();
  if constexpr (NQ % V == 0) {
    if (vec) {
      for (unsigned f = threadIdx.x * V; f < ne * NQ; f += kThreads * V) {
        cp_async<16>(dst + f, src + f);
      }
      return;
    }
  }
  for (unsigned f = threadIdx.x; f < ne * NQ; f += kThreads) cp_async<sizeof(T)>(dst + f, src + f);
}

// Stage J for group G on the group's `rows` rows from this thread's rho0:
// its TR rows are read once each (16-byte loads) and feed the group's
// chains, their table values constants; output q of a row goes to the
// next stage's input, or times D (the D stage), or to device memory (the
// last stage).  Each output is one FMA chain over its K inputs in
// ascending k, D multiplying the forward sum after it.
template <typename T, int DIM, int D1, int Q1, int J, int G>
__device__ __forceinline__ void stage_of(const Table<T, D1 * Q1>& tab, const T* __restrict__ in,
                                         T* __restrict__ nxt, const T* __restrict__ dbuf,
                                         T* __restrict__ outc, unsigned rho0, unsigned rows) {
  using S = StageOf<T, DIM, D1, Q1, J>;
  constexpr bool kFwd = J < DIM;
  constexpr bool kDStage = J == DIM - 1;
  constexpr bool kLast = J == 2 * DIM - 1;
  using N = StageOf<T, DIM, D1, Q1, kLast ? J : J + 1>;
  using VT = typename Vec16<T>::type;
  constexpr int V = vlen<T>(), K = S::K, TR = S::TR;
  constexpr int Q0 = G * S::TQ, NQ = imin(S::TQ, S::Q - Q0);  // this group's outputs
  constexpr unsigned ND = ipow(D1, DIM), EPB = elems_per_block(DIM, Q1);
  // a block of outputs apart: the next input's, out's (and D's: R)
  constexpr unsigned kOut = kLast ? S::R : S::R / S::Bn * N::P;
  auto out_at = [](unsigned rho) {
    return kLast ? flat_row(rho, S::R, ND) : out_row(rho, S::R, S::Bn, S::Q, N::P);
  };
  auto d_at = [](unsigned rho) { return flat_row(rho, S::R, S::Q * S::R); };
  const unsigned o0 = out_at(rho0) + Q0 * kOut, d0 = d_at(rho0) + Q0 * S::R;
  // the rows' offsets (AFF: constants added to row rho0's), and whether
  // each is one of the group's (a row past them reads row rho0)
  unsigned ii[TR], oo[TR], dd[TR];
  bool ok[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const unsigned rho = rho0 + i * S::TG;
    ok[i] = !(EPB > 1 || (i + 1) * S::TG > S::R) || rho < rows;
    ii[i] = (ok[i] ? rho : rho0) * S::P;
    oo[i] = S::AFF ? o0 + out_at(i * S::TG) : out_at(rho) + Q0 * kOut;
    dd[i] = S::AFF ? d0 + d_at(i * S::TG) : d_at(rho) + Q0 * S::R;
  }
  T acc[TR][NQ];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq) acc[i][qq] = T(0);
  }
#pragma unroll
  for (int kv = 0; kv < cdiv(K, V); ++kv) {
    VT x[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i) x[i] = reinterpret_cast<const VT*>(in + ii[i])[kv];
#pragma unroll
    for (int w = 0; w < V; ++w) {
      const int k = kv * V + w;
      if (k < K) {
#pragma unroll
        for (int qq = 0; qq < NQ; ++qq) {
          // B[q][k] forward, B^T[i][k] = B[k][i] on the way back
          const T b = tab.v[kFwd ? (Q0 + qq) * D1 + k : k * D1 + Q0 + qq];
#pragma unroll
          for (int i = 0; i < TR; ++i) acc[i][qq] = fmad(b, part(x[i], w), acc[i][qq]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    if (!ok[i]) continue;
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq) {
      T y = acc[i][qq];
      if constexpr (kDStage) y *= dbuf[dd[i] + qq * S::R];
      if constexpr (kLast) {
        outc[oo[i] + qq * kOut] = y;
      } else {
        nxt[oo[i] + qq * kOut] = y;
      }
    }
  }
}

template <typename T, int DIM, int D1, int Q1, int J, int... G>
__device__ __forceinline__ void stage_groups(const Table<T, D1 * Q1>& tab,
                                             const T* __restrict__ in, T* __restrict__ nxt,
                                             const T* __restrict__ dbuf, T* __restrict__ outc,
                                             unsigned g, unsigned rho0, unsigned rows,
                                             std::integer_sequence<int, G...>) {
  ((g == G ? stage_of<T, DIM, D1, Q1, J, G>(tab, in, nxt, dbuf, outc, rho0, rows) : void()),
   ...);
}

// Stage J on the group's ne elements: this thread's group (warp-uniform)
// and first row, then that group's code.
template <typename T, int DIM, int D1, int Q1, int J>
__device__ __forceinline__ void stage(const Table<T, D1 * Q1>& tab, const T* __restrict__ in,
                                      T* __restrict__ nxt, const T* __restrict__ dbuf,
                                      T* __restrict__ outc, unsigned ne) {
  using S = StageOf<T, DIM, D1, Q1, J>;
  constexpr unsigned EPB = elems_per_block(DIM, Q1);
  const unsigned t = threadIdx.x;
  if (S::NG * S::TG < kThreads && t >= S::NG * S::TG) return;
  const unsigned rho0 = t % S::TG, rows = ne * S::R;
  if ((EPB > 1 || S::TG > S::R) && rho0 >= rows) return;
  stage_groups<T, DIM, D1, Q1, J>(tab, in, nxt, dbuf, outc, t / S::TG, rho0, rows,
                                  std::make_integer_sequence<int, S::NG>{});
}


// ------------------------------------------------------------ sources ----
// An E-vector: u (C, NE, nd1^dim) and D (NE, nq1^dim), contiguous.  vec:
// bit 0 u, bit 1 D 16-byte aligned.
template <typename T>
struct ElemSrc {
  const T* u;
  const T* D;
  int NE, vec;

  template <int DIM, int D1, int Q1>
  __device__ __forceinline__ void fetch_u(T* dst, int c, int64_t e0, unsigned ne) const {
    fetch_u_flat<T, DIM, D1, Q1>(dst, u + (int64_t(c) * NE + e0) * ipow(D1, DIM), ne, vec & 1);
  }
  template <int DIM, int D1, int Q1>
  __device__ __forceinline__ void fetch_d(T* dst, int64_t e0, unsigned ne) const {
    fetch_d_flat<T, DIM, D1, Q1>(dst, D + e0 * ipow(Q1, DIM), ne, vec & 2);
  }
  __device__ __forceinline__ T u_at(int c, int64_t e, int f, int, int nd) const {
    return u[(int64_t(c) * NE + e) * nd + f];
  }
  __device__ __forceinline__ T d_at(int64_t e, int f, int, int nq) const { return D[e * nq + f]; }
};

// The raster lattice: u (C, Lz, Ly, Lx) with L = n p + 1 an axis and D the
// q-lattice (Qz, Qy, Qx) with Q = n nq1 (fewer axes in 2D and 1D: the
// missing ones have one element and one node).  Element e = (ez ny + ey)
// nx + ex (raster order, x fastest) holds the nodes (ez p + a, ey p + b,
// ex p + c) and the q-points (ez nq1 + i, ey nq1 + j, ex nq1 + k): a row
// of an element's dofs or q-points (x fastest) is a run of the lattice's,
// so no index map is needed.  vec: bit 1 when D's rows may be copied in
// 16-byte pieces (D and every q-lattice row 16-byte aligned).
template <typename T>
struct LatSrc {
  const T* u;
  const T* D;
  unsigned nx, ny;        // elements along x and y
  int64_t sy, sz, sc;     // u: a lattice row (Lx), plane (Lx Ly), component
  int64_t qy, qz;         // D: a q-lattice row (Qx), plane (Qx Qy)
  int vec;

  __device__ __forceinline__ void corner(unsigned e, unsigned& ex, unsigned& ey,
                                         unsigned& ez) const {
    const unsigned t = e / nx;
    ex = e - t * nx;
    ez = t / ny;
    ey = t - ez * ny;
  }
  // offset of value f (x fastest) of element e's d1^dim dofs, p = d1 - 1;
  // its row r = f / d1 is (a, b) = (r / d1, r % d1) in 3D, b = r in 2D
  __device__ __forceinline__ int64_t u_off(unsigned e, unsigned f, unsigned d1) const {
    unsigned ex, ey, ez;
    corner(e, ex, ey, ez);
    const unsigned p = d1 - 1, r = f / d1, k = f - r * d1;
    return int64_t(ez * p + r / d1) * sz + int64_t(ey * p + r % d1) * sy + (ex * p + k);
  }
  // offset of q-point f (x fastest) of element e's q1^dim
  __device__ __forceinline__ int64_t d_off(unsigned e, unsigned f, unsigned q1) const {
    unsigned ex, ey, ez;
    corner(e, ex, ey, ez);
    const unsigned r = f / q1, k = f - r * q1;
    return int64_t(ez * q1 + r / q1) * qz + int64_t(ey * q1 + r % q1) * qy + (ex * q1 + k);
  }

  // one component's dofs of the group's ne elements (the first e0) into the
  // first stage's rows: a copy a value (a row of an element starts at any
  // node of the lattice row)
  template <int DIM, int D1, int Q1>
  __device__ __forceinline__ void fetch_u(T* dst, int c, int64_t e0, unsigned ne) const {
    constexpr unsigned ND = ipow(D1, DIM), P = StageOf<T, DIM, D1, Q1, 0>::P;
    const T* uc = u + int64_t(c) * sc;
    for (unsigned f = threadIdx.x; f < ne * ND; f += kThreads) {
      const unsigned el = f / ND;
      cp_async<sizeof(T)>(dst + f / D1 * P + f % D1,
                          uc + u_off(unsigned(e0) + el, f - el * ND, D1));
    }
  }
  // the group's D as fetch_d_flat lays it out, 16-byte pieces of q-point
  // rows when vec allows
  template <int DIM, int D1, int Q1>
  __device__ __forceinline__ void fetch_d(T* dst, int64_t e0, unsigned ne) const {
    constexpr unsigned NQ = ipow(Q1, DIM), V = vlen<T>();
    if constexpr (Q1 % V == 0) {
      if (vec & 2) {
        for (unsigned f = threadIdx.x * V; f < ne * NQ; f += kThreads * V) {
          const unsigned el = f / NQ;
          cp_async<16>(dst + f, D + d_off(unsigned(e0) + el, f - el * NQ, Q1));
        }
        return;
      }
    }
    for (unsigned f = threadIdx.x; f < ne * NQ; f += kThreads) {
      const unsigned el = f / NQ;
      cp_async<sizeof(T)>(dst + f, D + d_off(unsigned(e0) + el, f - el * NQ, Q1));
    }
  }
  __device__ __forceinline__ T u_at(int c, int64_t e, int f, int d1, int) const {
    return u[int64_t(c) * sc + u_off(unsigned(e), unsigned(f), unsigned(d1))];
  }
  __device__ __forceinline__ T d_at(int64_t e, int f, int q1, int) const {
    return D[d_off(unsigned(e), unsigned(f), unsigned(q1))];
  }
};

// ------------------------------------------------------------- bodies ----
// The compiled instances' kernel body on `src`'s elements, writing the
// E-vector out (C, NE, nd1^dim), on the block's dynamic shared memory sm.
// One block per resident slot walks the groups blockIdx.x, blockIdx.x +
// gridDim.x, ... and their components in turn (a task).  The next task's u
// is copied in (cp.async) once stage 0 has read the current one, the next
// group's D once the last component's D stage has: both streams run under
// the contractions.  Every copy is committed as a group at one of those two
// points each task (empty groups where there is nothing to copy), so
// cp.async.wait_group 1 before stage 0 finds this task's u and before the
// D stage this group's D (in 2D, where the D stage follows stage 0 at once,
// wait_group 0).  One barrier before each stage.
template <typename T, int DIM, int D1, int Q1, class Src>
__device__ __forceinline__ void mass_body(const Src& src, T* __restrict__ out, int C, int NE,
                                          const Table<T, D1 * Q1>& tab, T* sm) {
  using L = LayoutOf<T, DIM, D1, Q1>;
  constexpr int EPB = elems_per_block(DIM, Q1);
  constexpr int ND = ipow(D1, DIM);
  T* const ubuf = sm + L::ubuf;
  T* const dbuf = sm + L::dbuf;
  T* const b0 = sm + L::buf0;
  T* const b1 = sm + L::buf1;
  const int groups = cdiv(NE, EPB);
  int grp = blockIdx.x;
  src.template fetch_u<DIM, D1, Q1>(ubuf, 0, int64_t(grp) * EPB, imin(EPB, NE - grp * EPB));
  cp_commit();
  src.template fetch_d<DIM, D1, Q1>(dbuf, int64_t(grp) * EPB, imin(EPB, NE - grp * EPB));
  cp_commit();
  for (; grp < groups; grp += gridDim.x) {
    const int64_t e0 = int64_t(grp) * EPB;
    const unsigned ne = imin(EPB, NE - grp * EPB);
    for (int c = 0; c < C; ++c) {
      const bool lastc = c + 1 == C;
      const int ng = lastc ? grp + static_cast<int>(gridDim.x) : grp;
      T* const outc = out + (int64_t(c) * NE + e0) * ND;
      cp_wait<1>();
      __syncthreads();
      stage<T, DIM, D1, Q1, 0>(tab, ubuf, b0, dbuf, outc, ne);
      if constexpr (DIM == 2) cp_wait<0>();
      __syncthreads();
      if (ng < groups) {
        src.template fetch_u<DIM, D1, Q1>(ubuf, lastc ? 0 : c + 1, int64_t(ng) * EPB,
                                          imin(EPB, NE - ng * EPB));
      }
      cp_commit();
      if constexpr (DIM == 3) {
        stage<T, DIM, D1, Q1, 1>(tab, b0, b1, dbuf, outc, ne);
        cp_wait<1>();
        __syncthreads();
        stage<T, DIM, D1, Q1, 2>(tab, b1, b0, dbuf, outc, ne);
      } else {
        stage<T, DIM, D1, Q1, 1>(tab, b0, b1, dbuf, outc, ne);
      }
      __syncthreads();
      if (lastc && ng < groups) {
        src.template fetch_d<DIM, D1, Q1>(dbuf, int64_t(ng) * EPB, imin(EPB, NE - ng * EPB));
      }
      cp_commit();
      if constexpr (DIM == 3) {
        stage<T, DIM, D1, Q1, 3>(tab, b0, b1, dbuf, outc, ne);
        __syncthreads();
        stage<T, DIM, D1, Q1, 4>(tab, b1, b0, dbuf, outc, ne);
        __syncthreads();
        stage<T, DIM, D1, Q1, 5>(tab, b0, b1, dbuf, outc, ne);
      } else {
        stage<T, DIM, D1, Q1, 2>(tab, b1, b0, dbuf, outc, ne);
        __syncthreads();
        stage<T, DIM, D1, Q1, 3>(tab, b0, b1, dbuf, outc, ne);
      }
    }
  }
  cp_wait<0>();
}

// The runtime-size kernel's body on `src`'s elements, a block a group,
// writing the E-vector out; the table B (q1, d1) from device memory.
template <typename T, class Src>
__device__ __forceinline__ void mass_body_rt(const Src& src, const T* __restrict__ B,
                                             T* __restrict__ out, int C, int NE, int dim, int d1,
                                             int q1, unsigned char* smem_raw) {
  const int epb = elems_per_block(dim, q1);
  const int nd = ipow(d1, dim), nq = ipow(q1, dim);
  const Smem<T> s = carve<T>(smem_raw, buf_size(dim, d1, q1, epb, 0),
                             buf_size(dim, d1, q1, epb, 1), d1, q1);
  const int64_t e0 = int64_t(blockIdx.x) * epb;
  const int ne = static_cast<int>(imin(epb, static_cast<int>(NE - e0)));
  load_tables(s, B, d1, q1);
  for (int c = 0; c < C; ++c) {
    const int64_t off = (int64_t(c) * NE + e0) * nd;
    load_u(s.buf[0], src, c, e0, nd, d1, geo(dim, d1, q1, epb, 0).R, epb, ne);
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
          if (dstage) acc *= (el < ne ? src.d_at(e0 + el, q * g.R + r, q1, nq) : T(0));
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

// ------------------------------------------------------------- launch ----
// The blocks of a compiled instance, `kernel` with smem bytes of dynamic
// shared memory a block, that the card holds at once: its grid, as every
// block walks groups until none is left.  Kept in the caller's `slots` (a
// static array for each instance), so found once per device: host calls
// cost microseconds on a host-bound path.  Opts in to the shared memory on
// the way.
template <typename K>
cudaError_t resident_grid(K kernel, int64_t smem, int device, int* slots, int* grid) {
  if (slots[device] == 0) {
    cudaError_t err = cudaSuccess;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                        static_cast<size_t>(smem));
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    slots[device] = imax(1, per_sm * sms);
  }
  *grid = slots[device];
  return cudaSuccess;
}

// the shared memory a block may opt in to on `device` (232,448 bytes on an
// H100), once per device; 0 or a CUDA error
inline int smem_limit(int device, int* limit) {
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
