// Fused pointwise quadrature-point physics for Hopper (sm_90a).
//
// Replaces the TPU kernels
//   laghos_tpu/ops/pallas_qphys.py::physics_3d_pallas9 (f32 build), and
//   laghos_tpu/ops/pallas_df64.py::physics_3d_pallas_df64 (f64 build; the
//   TPU has no FP64 ALU and ran the chain in two-f32 double-float, this
//   card runs it in native FP64).
// Both compute laghos_tpu/ops/qphys.py::physics_3d + _finish, the
// reference's QUpdateBody (laghos_solver.cpp:1042-1168): det and adjugate
// inverse of J, ideal-gas EOS, the physical velocity gradient, the
// smallest eigenpair of its symmetric part, h = h0 |J J0^-1 e| / |e|, the
// smooth-step artificial viscosity (optionally scaled by the vorticity
// coefficient), the min singular value of J from eig(J^T J), the CFL dt
// with dt = 0 for inverted or non-finite points, and the stress
// (sigma J^-T) w detJ.  The plain PyTorch twin is
// laghos_tpu_torch/ops/qphys.py::physics_3d_plain.
//
// Layout: structure of arrays.  J, dV, J0inv and sJit are (9, N) with
// component k = 3a + b of the 3x3 matrix [a][b]; e, rw, dtq are (N,);
// gamma is (NE,) indexed by p / NQ, winv (NQ,) by p % NQ.  One thread
// handles one point in a grid-stride loop; the ragged tail needs no padding.
//
// What bounds it: at the flagship size (3D Sedov, Q2-Q1, rs4: N = 2,097,152
// points) one call reads 29 point fields (27 for J, dV, J0inv, plus e and
// rw) and writes 10, each 2,097,152 x 8 B = 16.8 MB in f64, so about
// 0.65 GB per call: a floor of about 0.2 ms at the data-sheet 3.35 TB/s.
// The FP64 work (two 3x3 eigen-solves with f32 Jacobi sweeps, a few sqrt
// and div chains) is small beside that; coalesced SoA loads and one pass
// keep every intermediate in registers.  Expect register spills in the
// f64 instance; the point of this version is to be right, not fast.
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

constexpr int kBlock = 128;

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float maxval() { return 3.402823466e+38f; }
  static __device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }
  static __device__ __forceinline__ float sqrt(float x) { return sqrtf(x); }
  static __device__ __forceinline__ float abs(float x) { return fabsf(x); }
};

template <>
struct Num<double> {
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
  float t = sgn / (fabsf(tau_s) + sqrtf(1.0f + tau_s * tau_s));
  float c = 1.0f / sqrtf(1.0f + t * t);
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

// Smallest eigenpair of the symmetric 3x3 [[a00 a01 a02][. a11 a12][. . a22]]
// (smallmat.py:286-355): 4 cyclic Jacobi sweeps in float, pick the
// smallest diagonal entry, then Rayleigh quotient and (WANT_VEC) one
// adjugate null-space step in T.
template <typename T, bool WANT_VEC>
__device__ __forceinline__ void eig3s_hybrid(T a00, T a11, T a22, T a01, T a02, T a12,
                                             T& mu, T& ex, T& ey, T& ez) {
  float f00 = static_cast<float>(a00), f11 = static_cast<float>(a11);
  float f22 = static_cast<float>(a22), f01 = static_cast<float>(a01);
  float f02 = static_cast<float>(a02), f12 = static_cast<float>(a12);
  float V[3][3] = {{1.0f, 0.0f, 0.0f}, {0.0f, 1.0f, 0.0f}, {0.0f, 0.0f, 1.0f}};
  float c, s;
#pragma unroll
  for (int sweep = 0; sweep < 4; ++sweep) {
    jacobi_rot_step(f00, f11, f01, f02, f12, c, s);
    rotate_cols(V, c, s, 0, 1);
    jacobi_rot_step(f00, f22, f02, f01, f12, c, s);
    rotate_cols(V, c, s, 0, 2);
    jacobi_rot_step(f11, f22, f12, f01, f02, c, s);
    rotate_cols(V, c, s, 1, 2);
  }
  // _pick_smallest_f32, with its tie-break
  const bool m01 = f00 <= f11;
  const float mu01 = m01 ? f00 : f11;
  const float mu32 = nan_min(mu01, f22);
  const bool p0 = m01 && (f00 <= f22);
  const bool p1 = (!m01) && (f11 <= f22);
  const T vx = static_cast<T>(p0 ? V[0][0] : (p1 ? V[0][1] : V[0][2]));
  const T vy = static_cast<T>(p0 ? V[1][0] : (p1 ? V[1][1] : V[1][2]));
  const T vz = static_cast<T>(p0 ? V[2][0] : (p1 ? V[2][1] : V[2][2]));

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
  T m = nan_max(nan_max(Num<T>::abs(a00), Num<T>::abs(a11)),
                nan_max(Num<T>::abs(a22), Num<T>::abs(a01)));
  m = nan_max(m, nan_max(Num<T>::abs(a02), Num<T>::abs(a12)));
  // below ~1e-6 relative eigen-gap the cluster direction is arbitrary:
  // keep the f32 vector
  const T q = T(1e-6) * m * m;
  const bool good = (nu2 > q * q) && is_finite(nu2);
  const T inu = T(1) / Num<T>::sqrt(good ? nu2 : T(1));
  ex = good ? ux * inu : vx;
  ey = good ? uy * inu : vy;
  ez = good ? uz * inu : vz;
  const T mu2 = rayleigh(a00, a11, a22, a01, a02, a12, ex, ey, ez);
  if (good && is_finite(mu2)) mu = mu2;
}

template <typename T, bool VISC, bool VORT>
__global__ void __launch_bounds__(kBlock)
    qphys_kernel(const T* __restrict__ J, const T* __restrict__ dV,
                 const T* __restrict__ J0i, const T* __restrict__ e_q,
                 const T* __restrict__ rw, const T* __restrict__ gamma,
                 const T* __restrict__ winv, T* __restrict__ sJit, T* __restrict__ dtq,
                 int64_t N, int64_t NQ, T h0, T h1order, T cfl) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; p < N;
       p += stride) {
    const T j00 = J[p], j01 = J[N + p], j02 = J[2 * N + p];
    const T j10 = J[3 * N + p], j11 = J[4 * N + p], j12 = J[5 * N + p];
    const T j20 = J[6 * N + p], j21 = J[7 * N + p], j22 = J[8 * N + p];

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

    const T wi = winv[p % NQ];
    const T gam = gamma[p / NQ];
    const T R = rw[p] * wi * idet;
    const T E = nan_max(T(0), e_q[p]);
    const T P = (gam - T(1)) * R * E;
    const T S = Num<T>::sqrt(gam * (gam - T(1)) * E);

    T st00, st11, st22, st01, st02, st12, vR;
    if (VISC) {
      const T d00 = dV[p], d01 = dV[N + p], d02 = dV[2 * N + p];
      const T d10 = dV[3 * N + p], d11 = dV[4 * N + p], d12 = dV[5 * N + p];
      const T d20 = dV[6 * N + p], d21 = dV[7 * N + p], d22 = dV[8 * N + p];
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

      T mu, ex, ey, ez;
      eig3s_hybrid<T, true>(s00, s11, s22, s01, s02, s12, mu, ex, ey, ez);

      // Jpi = J . Jac0inv; ph = Jpi . e
      const T o00 = J0i[p], o01 = J0i[N + p], o02 = J0i[2 * N + p];
      const T o10 = J0i[3 * N + p], o11 = J0i[4 * N + p], o12 = J0i[5 * N + p];
      const T o20 = J0i[6 * N + p], o21 = J0i[7 * N + p], o22 = J0i[8 * N + p];
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

      T visc = T(2) * R * h * h * Num<T>::abs(mu);
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
      // pressure-only stress (inviscid problems): no eigen-solve
      st00 = -P;
      st11 = -P;
      st22 = -P;
      st01 = T(0);
      st02 = T(0);
      st12 = T(0);
      vR = T(0);
    }

    // _finish: min singular value of J via eig(J^T J), values only
    const T t00 = j00 * j00 + j10 * j10 + j20 * j20;
    const T t11 = j01 * j01 + j11 * j11 + j21 * j21;
    const T t22 = j02 * j02 + j12 * j12 + j22 * j22;
    const T t01 = j00 * j01 + j10 * j11 + j20 * j21;
    const T t02 = j00 * j02 + j10 * j12 + j20 * j22;
    const T t12 = j01 * j02 + j11 * j12 + j21 * j22;
    T lam, unused_x, unused_y, unused_z;
    eig3s_hybrid<T, false>(t00, t11, t22, t01, t02, t12, lam, unused_x, unused_y,
                           unused_z);
    const T sv = Num<T>::sqrt(nan_max(lam, T(0)));
    const T h_min = sv / h1order;
    const T ih = T(1) / h_min;
    const T idt = S * ih + T(2.5) * vR * ih * ih;
    const T dt = idt > T(0) ? cfl / idt : Num<T>::inf();
    // inverted elements reject the step (laghos_solver.cpp:1144-1148);
    // non-finite q-data must reject it too, not read as dt = inf
    const bool good = is_finite(detJ) && (detJ >= T(0)) && !is_nan(idt);
    dtq[p] = good ? dt : T(0);

    // sJit[gd][vd] = sum_k stress[vd][k] Jinv[gd][k] * w * detJ
    const T wd = detJ / wi;
    sJit[p] = (st00 * i00 + st01 * i01 + st02 * i02) * wd;
    sJit[N + p] = (st01 * i00 + st11 * i01 + st12 * i02) * wd;
    sJit[2 * N + p] = (st02 * i00 + st12 * i01 + st22 * i02) * wd;
    sJit[3 * N + p] = (st00 * i10 + st01 * i11 + st02 * i12) * wd;
    sJit[4 * N + p] = (st01 * i10 + st11 * i11 + st12 * i12) * wd;
    sJit[5 * N + p] = (st02 * i10 + st12 * i11 + st22 * i12) * wd;
    sJit[6 * N + p] = (st00 * i20 + st01 * i21 + st02 * i22) * wd;
    sJit[7 * N + p] = (st01 * i20 + st11 * i21 + st12 * i22) * wd;
    sJit[8 * N + p] = (st02 * i20 + st12 * i21 + st22 * i22) * wd;
  }
}

template <typename T, bool VISC, bool VORT>
void launch(const void* J, const void* dV, const void* J0i, const void* e_q, const void* rw,
            const void* gamma, const void* winv, void* sJit, void* dtq, int64_t N, int64_t NQ,
            double h0, double h1order, double cfl, cudaStream_t stream) {
  int64_t blocks = (N + kBlock - 1) / kBlock;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride loop covers the rest
  if (blocks < 1) blocks = 1;
  qphys_kernel<T, VISC, VORT><<<static_cast<unsigned>(blocks), kBlock, 0, stream>>>(
      static_cast<const T*>(J), static_cast<const T*>(dV), static_cast<const T*>(J0i),
      static_cast<const T*>(e_q), static_cast<const T*>(rw), static_cast<const T*>(gamma),
      static_cast<const T*>(winv), static_cast<T*>(sJit), static_cast<T*>(dtq), N, NQ,
      static_cast<T>(h0), static_cast<T>(h1order), static_cast<T>(cfl));
}

template <typename T>
void dispatch(int visc, int vort, const void* J, const void* dV, const void* J0i,
              const void* e_q, const void* rw, const void* gamma, const void* winv, void* sJit,
              void* dtq, int64_t N, int64_t NQ, double h0, double h1order, double cfl,
              cudaStream_t stream) {
  if (!visc) {
    launch<T, false, false>(J, dV, J0i, e_q, rw, gamma, winv, sJit, dtq, N, NQ, h0,
                            h1order, cfl, stream);
  } else if (vort) {
    launch<T, true, true>(J, dV, J0i, e_q, rw, gamma, winv, sJit, dtq, N, NQ, h0, h1order,
                          cfl, stream);
  } else {
    launch<T, true, false>(J, dV, J0i, e_q, rw, gamma, winv, sJit, dtq, N, NQ, h0,
                           h1order, cfl, stream);
  }
}

}  // namespace

// Plain C interface for ctypes.  dtype_code: 0 = float, 1 = double.
// Launches on `stream` (PyTorch's current stream), allocates nothing, does
// not synchronise, and returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unknown dtype code).
extern "C" int qphys_launch(int dtype_code, int device, const void* J, const void* dV,
                            const void* J0i, const void* e_q, const void* rw,
                            const void* gamma, const void* winv, void* sJit, void* dtq,
                            int64_t N, int64_t NQ, double h0, double h1order, double cfl,
                            int visc, int vort, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 1) {
    dispatch<double>(visc, vort, J, dV, J0i, e_q, rw, gamma, winv, sJit, dtq, N, NQ, h0,
                     h1order, cfl, s);
  } else if (dtype_code == 0) {
    dispatch<float>(visc, vort, J, dV, J0i, e_q, rw, gamma, winv, sJit, dtq, N, NQ, h0,
                    h1order, cfl, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* qphys_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
