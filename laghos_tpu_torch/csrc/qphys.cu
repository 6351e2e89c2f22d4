// Fused pointwise quadrature-point physics for Hopper (sm_90a).
//
// One kernel template, three memory layouts (the `Lay` policies below),
// each in an f64 and an f32 instance.  It replaces the TPU kernels
//   laghos_tpu/ops/pallas_qphys.py::physics_3d_pallas9 (element layout,
//     f32) and laghos_tpu/ops/pallas_df64.py::physics_3d_pallas_df64
//     (element layout, f64: the TPU has no FP64 ALU and ran the chain in
//     two-f32 double-float, this card runs it in native FP64);
//   laghos_tpu/ops/pallas_qphys.py::physics_3d_pallas_flat (q-lattice
//     layout, the whole-lattice q-update's kernel);
//   laghos_tpu/ops/pallas_qphys.py::physics_3d_pallas (packed layout).
// All compute laghos_tpu/ops/qphys.py::physics_3d + _finish, the
// reference's QUpdateBody (laghos_solver.cpp:1042-1168): det and adjugate
// inverse of J, ideal-gas EOS, the physical velocity gradient, the
// smallest eigenpair of its symmetric part, h = h0 |J J0^-1 e| / |e|, the
// smooth-step artificial viscosity (optionally scaled by the vorticity
// coefficient), the min singular value of J from eig(J^T J), the CFL dt
// with dt = 0 for inverted or non-finite points, and the stress
// (sigma J^-T) w detJ; optionally the viscosity coefficient.  The plain
// PyTorch twins are laghos_tpu_torch/ops/qphys.py::physics_3d_plain,
// physics_3d_lattice_plain and physics_3d_packed_plain.
//
// Layouts (component k = 3a + b of the 3x3 matrix [a][b]; e, rw, dtq and
// visc are (N,) over the N points):
//  * element: J, dV, J0inv, sJit are (9, N) with N = NE * NQ; gamma (NE,)
//    indexed by p / NQ, 1/w (NQ,) by p % NQ;
//  * q-lattice: the same (9, N) stacks over the q-lattice points, gamma and
//    1/w per point (N,), so no index division;
//  * packed: (N, 9), the 9 components of a point consecutive (the
//    (NE, NQ, 3, 3) array); gamma (NE,) by p / NQ and the weights W (NQ,)
//    by p % NQ, with 1/w formed here.
//
// What bounds it: the chain, not the bytes.  At the flagship size (3D
// Sedov, Q2-Q1, rs4: N = 2,097,152 points) one call reads 29 point fields
// (the q-lattice layout 31) and writes 10: about 0.65 GB in f64, 0.2 ms at
// the data-sheet 3.35 TB/s.  Split on an H100 (700 W) by two scratch
// builds: the same loads and stores with trivial arithmetic take 0.226 ms
// f64 (91 % of the bound), the chain alone (inputs from shared memory)
// about as long as the whole kernel, 0.396 ms.  The chain is two 3x3
// eigen-solves of 12 guarded f32 Jacobi rotations each, every rotation an
// IEEE divide, two square roots and two reciprocals, then the FP64
// refinements: about 4,000 SASS instructions a point (`chip_smoke.py`
// counts them), against ~1,000 floating-point operations of the
// algorithm.  The loads of one warp overlap the chains of the others
// already; what is left is instruction issue and dependency latency.  The
// q-lattice f64 instance takes 0.396 ms, 52 % of its byte bound.
//
// Design: one thread per point, its inputs loaded straight from device
// memory (coalesced in the SoA layouts), in a grid-stride loop of
// kBlock-thread blocks.  The lever that paid is residency:
// __launch_bounds__ holds the f64 instances to 80 registers (6 blocks, 24
// warps an SM; the first version compiled to 92-112), the f64 q-lattice
// one to 72 (7 blocks), and the f32 ones to 64 (8 blocks, 32 warps), at
// up to 64 bytes of spill stores (the f64 q-lattice instance) that cost
// less than the warps gain.  The element and packed layouts find a point's
// element and q-point by a multiply and a shift (div_nq), not a 64-bit
// division: that subroutine made them 4-9 % slower than the q-lattice
// instance and pushed them into spills.  Each rotation forms sgn / den as
// +-(1 / den) (exact: negation and round-to-nearest commute), which is
// cheaper than a divide.  Measured slower on this card and not kept: a
// persistent grid staging each tile's fields in shared memory with
// cp.async, the two Jacobi sweeps interleaved rotation by rotation, the
// Jacobi divides and square roots in double (PERF.md has the times).
//
// Numerics, chosen to match the reference implementation:
//  * The Jacobi sweeps of eig3s_hybrid run in float even for double input,
//    then the Rayleigh/adjugate refinements run in T
//    (laghos_tpu/ops/smallmat.py:240-355).
//  * max/min/clip propagate NaN like jnp.maximum/jnp.minimum/jnp.clip
//    (CUDA's fmax/fmin drop NaN), so non-finite q-data reaches dt = 0
//    through the `good` mask.
//  * No fast math: IEEE division and square root, no flush to zero.  nvcc
//    may contract a*b+c into FMA (its default).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 128;  // threads a block, one point each

template <typename T>
struct Num;

template <>
struct Num<float> {
  static constexpr int kMinBlocks = 8;  // resident blocks an SM: 64 registers
  static __device__ __forceinline__ float maxval() { return 3.402823466e+38f; }
  static __device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }
  static __device__ __forceinline__ float sqrt(float x) { return sqrtf(x); }
  static __device__ __forceinline__ float abs(float x) { return fabsf(x); }
};

template <>
struct Num<double> {
  static constexpr int kMinBlocks = 6;  // 80 registers
  static __device__ __forceinline__ double maxval() { return 1.7976931348623157e+308; }
  static __device__ __forceinline__ double inf() {
    return __longlong_as_double(0x7ff0000000000000LL);
  }
  static __device__ __forceinline__ double sqrt(double x) { return ::sqrt(x); }
  static __device__ __forceinline__ double abs(double x) { return fabs(x); }
};

template <typename T>
__device__ __forceinline__ bool is_nan(T x) {
  return x != x;
}

// false for NaN and +-inf, as jnp.isfinite
template <typename T>
__device__ __forceinline__ bool is_finite(T x) {
  return Num<T>::abs(x) <= Num<T>::maxval();
}

// NaN-propagating max/min: jnp.maximum / jnp.minimum
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return is_nan(a) ? a : (is_nan(b) ? b : (a > b ? a : b));
}

template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return is_nan(a) ? a : (is_nan(b) ? b : (a < b ? a : b));
}

// One guarded Jacobi rotation in the (p,q) plane, r the third index
// (smallmat.py:107-162), in float.  On return (c, s) is the applied
// rotation, or (1, 0) when it was skipped.
__device__ __forceinline__ void jacobi_rot_step(float& app, float& aqq, float& apq,
                                                float& arp, float& arq, float& c_out,
                                                float& s_out) {
  const bool nonzero = apq != 0.0f;
  const float safe = nonzero ? apq : 1.0f;
  const float tau = (aqq - app) / (2.0f * safe);
  const bool ok = nonzero && is_finite(tau);
  const float sgn = (tau >= 0.0f) ? 1.0f : -1.0f;
  const float tau_s = ok ? tau : 0.0f;
  // sgn / den as +-(1 / den): negation is exact and rounding symmetric, so
  // the IEEE reciprocal gives the quotient's bits with fewer instructions
  const float r = __frcp_rn(fabsf(tau_s) + sqrtf(1.0f + tau_s * tau_s));
  float t = sgn > 0.0f ? r : -r;
  float c = __frcp_rn(sqrtf(1.0f + t * t));
  float s = t * c;
  c = ok ? c : 1.0f;
  s = ok ? s : 0.0f;
  t = ok ? t : 0.0f;
  const float app_n = app - t * apq;
  const float aqq_n = aqq + t * apq;
  const float arp_n = c * arp - s * arq;
  const float arq_n = s * arp + c * arq;
  const bool bad = is_nan(app_n) || is_nan(aqq_n) || is_nan(arp_n) || is_nan(arq_n);
  if (bad) {
    c_out = 1.0f;
    s_out = 0.0f;
  } else {
    app = app_n;
    aqq = aqq_n;
    apq = 0.0f;
    arp = arp_n;
    arq = arq_n;
    c_out = c;
    s_out = s;
  }
}

__device__ __forceinline__ void rotate_cols(float (&V)[3][3], float c, float s, int p, int q) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float vip = V[i][p];
    const float viq = V[i][q];
    V[i][p] = c * vip - s * viq;
    V[i][q] = s * vip + c * viq;
  }
}

template <typename T>
__device__ __forceinline__ T rayleigh(T a00, T a11, T a22, T a01, T a02, T a12, T x, T y,
                                      T z) {
  const T Ax = a00 * x + a01 * y + a02 * z;
  const T Ay = a01 * x + a11 * y + a12 * z;
  const T Az = a02 * x + a12 * y + a22 * z;
  const T num = x * Ax + y * Ay + z * Az;
  const T den = x * x + y * y + z * z;
  return num / (den == T(0) ? T(1) : den);
}

// A symmetric 3x3 matrix in T, its f32 copy under Jacobi rotations, and
// the accumulated rotations V.
template <typename T>
struct Sym3 {
  T a00, a11, a22, a01, a02, a12;
  float f00, f11, f22, f01, f02, f12;
  float V[3][3];
  __device__ __forceinline__ Sym3(T b00, T b11, T b22, T b01, T b02, T b12)
      : a00(b00), a11(b11), a22(b22), a01(b01), a02(b02), a12(b12),
        f00(static_cast<float>(b00)), f11(static_cast<float>(b11)),
        f22(static_cast<float>(b22)), f01(static_cast<float>(b01)),
        f02(static_cast<float>(b02)), f12(static_cast<float>(b12)),
        V{{1.0f, 0.0f, 0.0f}, {0.0f, 1.0f, 0.0f}, {0.0f, 0.0f, 1.0f}} {}

  // rotation r (0: plane (0,1), 1: (0,2), 2: (1,2)) of the cyclic sweep
  __device__ __forceinline__ void rotate(int r) {
    float c, s;
    if (r == 0) {
      jacobi_rot_step(f00, f11, f01, f02, f12, c, s);
      rotate_cols(V, c, s, 0, 1);
    } else if (r == 1) {
      jacobi_rot_step(f00, f22, f02, f01, f12, c, s);
      rotate_cols(V, c, s, 0, 2);
    } else {
      jacobi_rot_step(f11, f22, f12, f01, f02, c, s);
      rotate_cols(V, c, s, 1, 2);
    }
  }
};

// 4 cyclic Jacobi sweeps of one matrix (smallmat.py:286-355).
template <typename T>
__device__ __forceinline__ void jacobi_sweeps(Sym3<T>& m) {
#pragma unroll
  for (int sweep = 0; sweep < 4; ++sweep) {
#pragma unroll
    for (int r = 0; r < 3; ++r) m.rotate(r);
  }
}

// Smallest eigenpair after the sweeps (smallmat.py:286-355): pick the
// smallest diagonal entry, then Rayleigh quotient and (WANT_VEC) one
// adjugate null-space step in T.
template <typename T, bool WANT_VEC>
__device__ __forceinline__ void eig3s_finish(const Sym3<T>& m, T& mu, T& ex, T& ey, T& ez) {
  const T a00 = m.a00, a11 = m.a11, a22 = m.a22, a01 = m.a01, a02 = m.a02, a12 = m.a12;
  // _pick_smallest_f32, with its tie-break
  const bool m01 = m.f00 <= m.f11;
  const float mu01 = m01 ? m.f00 : m.f11;
  const float mu32 = nan_min(mu01, m.f22);
  const bool p0 = m01 && (m.f00 <= m.f22);
  const bool p1 = (!m01) && (m.f11 <= m.f22);
  const T vx = static_cast<T>(p0 ? m.V[0][0] : (p1 ? m.V[0][1] : m.V[0][2]));
  const T vy = static_cast<T>(p0 ? m.V[1][0] : (p1 ? m.V[1][1] : m.V[1][2]));
  const T vz = static_cast<T>(p0 ? m.V[2][0] : (p1 ? m.V[2][1] : m.V[2][2]));

  mu = rayleigh(a00, a11, a22, a01, a02, a12, vx, vy, vz);
  if (!is_finite(mu)) mu = static_cast<T>(mu32);
  if (!WANT_VEC) return;

  // adjugate null-space step: u = adj(A - mu I) . v
  const T b00 = a00 - mu;
  const T b11 = a11 - mu;
  const T b22 = a22 - mu;
  const T c00 = b11 * b22 - a12 * a12;
  const T c01 = a02 * a12 - a01 * b22;
  const T c02 = a01 * a12 - a02 * b11;
  const T c11 = b00 * b22 - a02 * a02;
  const T c12 = a01 * a02 - b00 * a12;
  const T c22 = b00 * b11 - a01 * a01;
  const T ux = c00 * vx + c01 * vy + c02 * vz;
  const T uy = c01 * vx + c11 * vy + c12 * vz;
  const T uz = c02 * vx + c12 * vy + c22 * vz;
  const T nu2 = ux * ux + uy * uy + uz * uz;
  T mm = nan_max(nan_max(Num<T>::abs(a00), Num<T>::abs(a11)),
                 nan_max(Num<T>::abs(a22), Num<T>::abs(a01)));
  mm = nan_max(mm, nan_max(Num<T>::abs(a02), Num<T>::abs(a12)));
  // below ~1e-6 relative eigen-gap the cluster direction is arbitrary:
  // keep the f32 vector
  const T q = T(1e-6) * mm * mm;
  const bool good = (nu2 > q * q) && is_finite(nu2);
  const T inu = T(1) / Num<T>::sqrt(good ? nu2 : T(1));
  ex = good ? ux * inu : vx;
  ey = good ? uy * inu : vy;
  ez = good ? uz * inu : vz;
  const T mu2 = rayleigh(a00, a11, a22, a01, a02, a12, ex, ey, ez);
  if (good && is_finite(mu2)) mu = mu2;
}

// The physics of one point.  `in` gives the inputs (J(c), dV(c), J0(c),
// e(), rw(), gam(), wi()); the results are the 9 components of sJit, dtq
// and the viscosity coefficient.
template <typename T, bool VISC, bool VORT, class In>
__device__ __forceinline__ void point_physics(const In& in, T h0, T h1order, T cfl,
                                              T (&sJ)[9], T& dtq, T& visc) {
  const T j00 = in.J(0), j01 = in.J(1), j02 = in.J(2);
  const T j10 = in.J(3), j11 = in.J(4), j12 = in.J(5);
  const T j20 = in.J(6), j21 = in.J(7), j22 = in.J(8);

  // det + inverse (adjugate)
  const T c00 = j11 * j22 - j12 * j21;
  const T c01 = j02 * j21 - j01 * j22;
  const T c02 = j01 * j12 - j02 * j11;
  const T c10 = j12 * j20 - j10 * j22;
  const T c11 = j00 * j22 - j02 * j20;
  const T c12 = j02 * j10 - j00 * j12;
  const T c20 = j10 * j21 - j11 * j20;
  const T c21 = j01 * j20 - j00 * j21;
  const T c22 = j00 * j11 - j01 * j10;
  const T detJ = j00 * c00 + j01 * c10 + j02 * c20;
  const T idet = T(1) / detJ;
  const T i00 = c00 * idet, i01 = c01 * idet, i02 = c02 * idet;
  const T i10 = c10 * idet, i11 = c11 * idet, i12 = c12 * idet;
  const T i20 = c20 * idet, i21 = c21 * idet, i22 = c22 * idet;

  const T gam = in.gam(), wi = in.wi();
  const T R = in.rw() * wi * idet;
  const T E = nan_max(T(0), in.e());
  const T P = (gam - T(1)) * R * E;
  const T S = Num<T>::sqrt(gam * (gam - T(1)) * E);

  T st00, st11, st22, st01, st02, st12, vR;
  visc = T(0);
  if (VISC) {
    const T d00 = in.dV(0), d01 = in.dV(1), d02 = in.dV(2);
    const T d10 = in.dV(3), d11 = in.dV(4), d12 = in.dV(5);
    const T d20 = in.dV(6), d21 = in.dV(7), d22 = in.dV(8);
    // sgrad = dV . Jinv (physical velocity gradient)
    const T g00 = d00 * i00 + d01 * i10 + d02 * i20;
    const T g01 = d00 * i01 + d01 * i11 + d02 * i21;
    const T g02 = d00 * i02 + d01 * i12 + d02 * i22;
    const T g10 = d10 * i00 + d11 * i10 + d12 * i20;
    const T g11 = d10 * i01 + d11 * i11 + d12 * i21;
    const T g12 = d10 * i02 + d11 * i12 + d12 * i22;
    const T g20 = d20 * i00 + d21 * i10 + d22 * i20;
    const T g21 = d20 * i01 + d21 * i11 + d22 * i21;
    const T g22 = d20 * i02 + d21 * i12 + d22 * i22;

    T vorticity_coeff = T(1);
    if (VORT) {
      const T fro = Num<T>::sqrt(g00 * g00 + g01 * g01 + g02 * g02 + g10 * g10 +
                                 g11 * g11 + g12 * g12 + g20 * g20 + g21 * g21 +
                                 g22 * g22);
      const T dv = Num<T>::abs(g00 + g11 + g22);
      vorticity_coeff = fro > T(0) ? dv / nan_max(fro, T(1e-300)) : T(1);
    }

    const T s00 = g00, s11 = g11, s22 = g22;
    const T s01 = T(0.5) * (g01 + g10);
    const T s02 = T(0.5) * (g02 + g20);
    const T s12 = T(0.5) * (g12 + g21);

    Sym3<T> strain(s00, s11, s22, s01, s02, s12);
    jacobi_sweeps(strain);
    T mu, ex, ey, ez;
    eig3s_finish<T, true>(strain, mu, ex, ey, ez);

    // Jpi = J . Jac0inv; ph = Jpi . e
    const T o00 = in.J0(0), o01 = in.J0(1), o02 = in.J0(2);
    const T o10 = in.J0(3), o11 = in.J0(4), o12 = in.J0(5);
    const T o20 = in.J0(6), o21 = in.J0(7), o22 = in.J0(8);
    const T p00 = j00 * o00 + j01 * o10 + j02 * o20;
    const T p01 = j00 * o01 + j01 * o11 + j02 * o21;
    const T p02 = j00 * o02 + j01 * o12 + j02 * o22;
    const T p10 = j10 * o00 + j11 * o10 + j12 * o20;
    const T p11 = j10 * o01 + j11 * o11 + j12 * o21;
    const T p12 = j10 * o02 + j11 * o12 + j12 * o22;
    const T p20 = j20 * o00 + j21 * o10 + j22 * o20;
    const T p21 = j20 * o01 + j21 * o11 + j22 * o21;
    const T p22 = j20 * o02 + j21 * o12 + j22 * o22;
    const T phx = p00 * ex + p01 * ey + p02 * ez;
    const T phy = p10 * ex + p11 * ey + p12 * ez;
    const T phz = p20 * ex + p21 * ey + p22 * ez;
    const T h = (h0 * Num<T>::sqrt(phx * phx + phy * phy + phz * phz)) /
                Num<T>::sqrt(ex * ex + ey * ey + ez * ez);

    visc = T(2) * R * h * h * Num<T>::abs(mu);
    // smooth step over [-eps, eps] at mu - 2 eps, eps = 1e-12
    T y = (mu - T(2e-12) + T(1e-12)) / T(2e-12);
    y = nan_min(nan_max(y, T(0)), T(1));
    const T step = (T(3) - T(2) * y) * y * y;
    visc = visc + (T(0.5) * R * h * S * vorticity_coeff * (T(1) - step));

    st00 = -P + visc * s00;
    st11 = -P + visc * s11;
    st22 = -P + visc * s22;
    st01 = visc * s01;
    st02 = visc * s02;
    st12 = visc * s12;
    vR = visc / R;
  } else {
    // pressure-only stress (inviscid problems): no strain-rate eigen-solve
    st00 = -P;
    st11 = -P;
    st22 = -P;
    st01 = T(0);
    st02 = T(0);
    st12 = T(0);
    vR = T(0);
  }

  // _finish: dt from the min singular value of J, from eig(J^T J)
  Sym3<T> jtj(j00 * j00 + j10 * j10 + j20 * j20, j01 * j01 + j11 * j11 + j21 * j21,
              j02 * j02 + j12 * j12 + j22 * j22, j00 * j01 + j10 * j11 + j20 * j21,
              j00 * j02 + j10 * j12 + j20 * j22, j01 * j02 + j11 * j12 + j21 * j22);
  jacobi_sweeps(jtj);
  T lam, unused_x, unused_y, unused_z;
  eig3s_finish<T, false>(jtj, lam, unused_x, unused_y, unused_z);
  const T sv = Num<T>::sqrt(nan_max(lam, T(0)));
  const T h_min = sv / h1order;
  const T ih = T(1) / h_min;
  const T idt = S * ih + T(2.5) * vR * ih * ih;
  const T dt = idt > T(0) ? cfl / idt : Num<T>::inf();
  // inverted elements reject the step (laghos_solver.cpp:1144-1148);
  // non-finite q-data must reject it too, not read as dt = inf
  const bool good = is_finite(detJ) && (detJ >= T(0)) && !is_nan(idt);
  dtq = good ? dt : T(0);

  // sJit[gd][vd] = sum_k stress[vd][k] Jinv[gd][k] * w * detJ
  const T wd = detJ / wi;
  sJ[0] = (st00 * i00 + st01 * i01 + st02 * i02) * wd;
  sJ[1] = (st01 * i00 + st11 * i01 + st12 * i02) * wd;
  sJ[2] = (st02 * i00 + st12 * i01 + st22 * i02) * wd;
  sJ[3] = (st00 * i10 + st01 * i11 + st02 * i12) * wd;
  sJ[4] = (st01 * i10 + st11 * i11 + st12 * i12) * wd;
  sJ[5] = (st02 * i10 + st12 * i11 + st22 * i12) * wd;
  sJ[6] = (st00 * i20 + st01 * i21 + st02 * i22) * wd;
  sJ[7] = (st01 * i20 + st11 * i21 + st12 * i22) * wd;
  sJ[8] = (st02 * i20 + st12 * i21 + st22 * i22) * wd;
}

// Arguments of one launch.  The element and packed layouts index gamma
// by p / NQ and the weights by p % NQ, with p / NQ as (p * nq_mul) >>
// nq_shift: a 64-bit integer division is a long subroutine in the chain of
// every point.
template <typename T>
struct Args {
  const T *J, *dV, *J0i, *e_q, *rw, *gamma, *winv;
  T *sJit, *dtq, *visc;
  int64_t N, NQ;
  T h0, h1order, cfl;
  uint64_t nq_mul;
  int nq_shift;
};

// p / NQ for 0 <= p < 2^31: with l = ceil(log2 NQ), s = 31 + l and m =
// ceil(2^s / NQ), p m / 2^s exceeds p / NQ by less than 2^-l <= 1 / NQ,
// so the floor is exact.
template <typename T>
__device__ __forceinline__ int64_t div_nq(const Args<T>& a, int64_t p) {
  return static_cast<int64_t>((static_cast<uint64_t>(p) * a.nq_mul) >> a.nq_shift);
}

// ------------------------------------------------------------ layouts --
// A layout policy says where component c of a 3x3 field (and of sJit) of
// point p sits (`index`), and where gamma and 1/w of a point come from.
enum Layout { kElement = 0, kLattice = 1, kPacked = 2 };

template <int LAYOUT>
struct Lay;

// element SoA: fields (9, N) with N = NE * NQ; gamma per element, 1/w per
// q-point (NE and NQ values, cached)
template <>
struct Lay<kElement> {
  static __device__ __forceinline__ int64_t index(int64_t p, int64_t N, int c) {
    return c * N + p;
  }
  template <typename T>
  static __device__ __forceinline__ T gam(const Args<T>& a, int64_t p) {
    return a.gamma[div_nq(a, p)];
  }
  template <typename T>
  static __device__ __forceinline__ T wi(const Args<T>& a, int64_t p) {
    return a.winv[p - div_nq(a, p) * a.NQ];
  }
};

// q-lattice SoA: fields (9, N) over the N points of the q-lattice, gamma
// and 1/w given per point
template <>
struct Lay<kLattice> {
  static __device__ __forceinline__ int64_t index(int64_t p, int64_t N, int c) {
    return c * N + p;
  }
  template <typename T>
  static __device__ __forceinline__ T gam(const Args<T>& a, int64_t p) {
    return a.gamma[p];
  }
  template <typename T>
  static __device__ __forceinline__ T wi(const Args<T>& a, int64_t p) {
    return a.winv[p];
  }
};

// packed AoS: fields (NE, NQ, 3, 3), the 9 components of a point
// consecutive; gamma per element; `winv` holds the weights W (NQ,) and 1/w
// is formed here, as physics_3d_pallas forms it
template <>
struct Lay<kPacked> {
  static __device__ __forceinline__ int64_t index(int64_t p, int64_t, int c) {
    return 9 * p + c;
  }
  template <typename T>
  static __device__ __forceinline__ T gam(const Args<T>& a, int64_t p) {
    return a.gamma[div_nq(a, p)];
  }
  template <typename T>
  static __device__ __forceinline__ T wi(const Args<T>& a, int64_t p) {
    return T(1) / a.winv[p - div_nq(a, p) * a.NQ];
  }
};

// The inputs of point p, read from device memory as the chain needs them.
template <typename T, int LAYOUT>
struct Direct {
  using L = Lay<LAYOUT>;
  const Args<T>& a;
  int64_t p;
  __device__ __forceinline__ T J(int c) const { return a.J[L::index(p, a.N, c)]; }
  __device__ __forceinline__ T dV(int c) const { return a.dV[L::index(p, a.N, c)]; }
  __device__ __forceinline__ T J0(int c) const { return a.J0i[L::index(p, a.N, c)]; }
  __device__ __forceinline__ T e() const { return a.e_q[p]; }
  __device__ __forceinline__ T rw() const { return a.rw[p]; }
  __device__ __forceinline__ T gam() const { return L::gam(a, p); }
  __device__ __forceinline__ T wi() const { return L::wi(a, p); }
};

// resident blocks an SM asked of ptxas (it caps the registers at 64K /
// (kBlock x this)); the f64 q-lattice instance, the main path's, reads
// gamma and 1/w per point and fits one more block (72 registers)
template <typename T, int LAYOUT>
constexpr int min_blocks() {
  return sizeof(T) == 8 && LAYOUT == kLattice ? 7 : Num<T>::kMinBlocks;
}

// One thread per point, in a grid-stride loop.
template <typename T, int LAYOUT, bool VISC, bool VORT>
__global__ void __launch_bounds__(kBlock, (min_blocks<T, LAYOUT>()))
    qphys_kernel(__grid_constant__ const Args<T> a) {
  using L = Lay<LAYOUT>;
  for (int64_t p = int64_t(blockIdx.x) * kBlock + threadIdx.x; p < a.N;
       p += int64_t(gridDim.x) * kBlock) {
    T sJ[9], dt, visc;
    point_physics<T, VISC, VORT>(Direct<T, LAYOUT>{a, p}, a.h0, a.h1order, a.cfl, sJ, dt,
                                 visc);
    if (a.visc != nullptr) a.visc[p] = visc;
    a.dtq[p] = dt;
#pragma unroll
    for (int c = 0; c < 9; ++c) a.sJit[L::index(p, a.N, c)] = sJ[c];
  }
}

struct RawArgs {
  const void *J, *dV, *J0i, *e_q, *rw, *gamma, *winv;
  void *sJit, *dtq, *visc;
  int64_t N, NQ;
  double h0, h1order, cfl;
};

template <typename T, int LAYOUT, bool VISC, bool VORT>
cudaError_t launch(const RawArgs& r, cudaStream_t stream) {
  if (LAYOUT != kLattice && (r.NQ < 1 || r.N >= (int64_t(1) << 31))) return cudaErrorInvalidValue;
  int l = 0;
  while ((int64_t(1) << l) < r.NQ) ++l;
  const int shift = 31 + l;
  const uint64_t mul = r.NQ < 1 ? 0 : ((uint64_t(1) << shift) + r.NQ - 1) / r.NQ;
  const Args<T> a{static_cast<const T*>(r.J),     static_cast<const T*>(r.dV),
                  static_cast<const T*>(r.J0i),   static_cast<const T*>(r.e_q),
                  static_cast<const T*>(r.rw),    static_cast<const T*>(r.gamma),
                  static_cast<const T*>(r.winv),  static_cast<T*>(r.sJit),
                  static_cast<T*>(r.dtq),         static_cast<T*>(r.visc),
                  r.N,                            r.NQ,
                  static_cast<T>(r.h0),           static_cast<T>(r.h1order),
                  static_cast<T>(r.cfl),          mul,
                  shift};
  const int64_t blocks = (r.N + kBlock - 1) / kBlock;  // the loop covers the rest
  qphys_kernel<T, LAYOUT, VISC, VORT>
      <<<static_cast<unsigned>(blocks < (1 << 30) ? blocks : (1 << 30)), kBlock, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int LAYOUT>
cudaError_t dispatch_flags(int visc, int vort, const RawArgs& a, cudaStream_t stream) {
  if (!visc) return launch<T, LAYOUT, false, false>(a, stream);
  if (vort) return launch<T, LAYOUT, true, true>(a, stream);
  return launch<T, LAYOUT, true, false>(a, stream);
}

template <typename T>
cudaError_t dispatch(int layout, int visc, int vort, const RawArgs& a, cudaStream_t stream) {
  switch (layout) {
    case kElement:
      return dispatch_flags<T, kElement>(visc, vort, a, stream);
    case kLattice:
      return dispatch_flags<T, kLattice>(visc, vort, a, stream);
    case kPacked:
      return dispatch_flags<T, kPacked>(visc, vort, a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface for ctypes.  layout: 0 = element, 1 = q-lattice,
// 2 = packed (see Layout); dtype_code: 0 = float, 1 = double.  `visc` may
// be null (no viscosity output); `dV` is not read when visc_flag is 0; NQ
// is not read by the lattice layout.  The element and packed layouts take
// N < 2^31 points and NQ >= 1.  Launches on `stream` (PyTorch's current
// stream), allocates nothing, does not synchronise, and returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unknown layout or dtype code, or N or NQ out of range).
extern "C" int qphys_launch(int layout, int dtype_code, int device, const void* J,
                            const void* dV, const void* J0i, const void* e_q, const void* rw,
                            const void* gamma, const void* winv, void* sJit, void* dtq,
                            void* visc, int64_t N, int64_t NQ, double h0, double h1order,
                            double cfl, int visc_flag, int vort, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (N <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RawArgs a{J, dV, J0i, e_q, rw, gamma, winv, sJit, dtq, visc, N, NQ, h0, h1order, cfl};
  if (dtype_code == 1) {
    err = dispatch<double>(layout, visc_flag, vort, a, s);
  } else if (dtype_code == 0) {
    err = dispatch<float>(layout, visc_flag, vort, a, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* qphys_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
