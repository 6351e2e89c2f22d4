"""Pointwise quadrature physics of the 3D q-update.

The q-update splits into (a) sum-factorized interpolation (ops/tensor.py)
and (b) a purely pointwise physics chain: EOS, artificial viscosity, the
eigen-solves and the dt estimate.  This module is (b):

* `physics_3d_plain` is the line-by-line torch translation of
  `laghos_tpu.ops.qphys.physics_3d` (+ `_finish`), the reference's
  QUpdateBody (laghos_solver.cpp:1042-1168);
* `physics_3d` is the entry point the q-update calls.  For CPU tensors it
  runs the plain version; for CUDA tensors it launches the hand-written
  kernel `csrc/qphys.cu` (f64 or f32 instance) and raises if that fails.

Layout: the JAX package carries the 3x3 point fields as 9-tuples of
(NE, NQ) arrays, component k = 3a + b of [a][b].  Here they are the same
components stacked on a leading axis, (9, NE, NQ), contiguous, which is the
kernel's structure-of-arrays layout.
"""

from __future__ import annotations

import torch

from . import kernels
from .smallmat import eig3s_hybrid


def physics_3d_plain(J9, dV9, J0i9, e_q, rw, gamma, winv, *, h0_e, h1order,
                     cfl, use_viscosity=True, use_vorticity=False):
    """Plain torch version of the fused kernel; same arguments and
    results as `physics_3d`."""
    (j00, j01, j02, j10, j11, j12, j20, j21, j22) = J9.unbind(0)
    gamma = gamma[:, None]
    winv = winv[None, :]
    # det + inverse (adjugate)
    c00 = j11 * j22 - j12 * j21
    c01 = j02 * j21 - j01 * j22
    c02 = j01 * j12 - j02 * j11
    c10 = j12 * j20 - j10 * j22
    c11 = j00 * j22 - j02 * j20
    c12 = j02 * j10 - j00 * j12
    c20 = j10 * j21 - j11 * j20
    c21 = j01 * j20 - j00 * j21
    c22 = j00 * j11 - j01 * j10
    detJ = j00 * c00 + j01 * c10 + j02 * c20
    idet = 1.0 / detJ
    i00, i01, i02 = c00 * idet, c01 * idet, c02 * idet
    i10, i11, i12 = c10 * idet, c11 * idet, c12 * idet
    i20, i21, i22 = c20 * idet, c21 * idet, c22 * idet

    R = rw * winv * idet
    E = torch.maximum(torch.zeros_like(e_q), e_q)
    P = (gamma - 1.0) * R * E
    S = torch.sqrt(gamma * (gamma - 1.0) * E)

    Jinv = ((i00, i01, i02), (i10, i11, i12), (i20, i21, i22))
    if not use_viscosity:
        # pressure-only stress (inviscid problems): no eigen-solve
        zero = torch.zeros_like(P)
        return _finish(J9, (-P, -P, -P, zero, zero, zero), zero, Jinv, detJ,
                       S, winv, h1order=h1order, cfl=cfl)

    # sgrad = dV . Jinv (physical velocity gradient)
    (d00, d01, d02, d10, d11, d12, d20, d21, d22) = dV9.unbind(0)
    g00 = d00 * i00 + d01 * i10 + d02 * i20
    g01 = d00 * i01 + d01 * i11 + d02 * i21
    g02 = d00 * i02 + d01 * i12 + d02 * i22
    g10 = d10 * i00 + d11 * i10 + d12 * i20
    g11 = d10 * i01 + d11 * i11 + d12 * i21
    g12 = d10 * i02 + d11 * i12 + d12 * i22
    g20 = d20 * i00 + d21 * i10 + d22 * i20
    g21 = d20 * i01 + d21 * i11 + d22 * i21
    g22 = d20 * i02 + d21 * i12 + d22 * i22

    vorticity_coeff = 1.0
    if use_vorticity:
        fro = torch.sqrt(g00 * g00 + g01 * g01 + g02 * g02 + g10 * g10
                         + g11 * g11 + g12 * g12 + g20 * g20 + g21 * g21
                         + g22 * g22)
        div = torch.abs(g00 + g11 + g22)
        tiny = torch.full_like(fro, 1e-300)
        vorticity_coeff = torch.where(fro > 0.0,
                                      div / torch.maximum(fro, tiny),
                                      torch.ones_like(fro))

    s00, s11, s22 = g00, g11, g22
    s01 = 0.5 * (g01 + g10)
    s02 = 0.5 * (g02 + g20)
    s12 = 0.5 * (g12 + g21)

    # smallest eigenpair of the strain rate: f32 Jacobi sweeps + Rayleigh/
    # adjugate refinement in the working precision
    mu, (ex, ey, ez) = eig3s_hybrid(s00, s11, s22, s01, s02, s12)

    # Jpi = J . Jac0inv; ph = Jpi . e
    (o00, o01, o02, o10, o11, o12, o20, o21, o22) = J0i9.unbind(0)
    p00 = j00 * o00 + j01 * o10 + j02 * o20
    p01 = j00 * o01 + j01 * o11 + j02 * o21
    p02 = j00 * o02 + j01 * o12 + j02 * o22
    p10 = j10 * o00 + j11 * o10 + j12 * o20
    p11 = j10 * o01 + j11 * o11 + j12 * o21
    p12 = j10 * o02 + j11 * o12 + j12 * o22
    p20 = j20 * o00 + j21 * o10 + j22 * o20
    p21 = j20 * o01 + j21 * o11 + j22 * o21
    p22 = j20 * o02 + j21 * o12 + j22 * o22
    phx = p00 * ex + p01 * ey + p02 * ez
    phy = p10 * ex + p11 * ey + p12 * ez
    phz = p20 * ex + p21 * ey + p22 * ez
    h = (h0_e * torch.sqrt(phx * phx + phy * phy + phz * phz)
         / torch.sqrt(ex * ex + ey * ey + ez * ez))

    visc = 2.0 * R * h * h * torch.abs(mu)
    eps = 1e-12
    y = (mu - 2.0 * eps + eps) / (2.0 * eps)
    y = torch.minimum(torch.maximum(y, torch.zeros_like(y)),
                      torch.ones_like(y))
    step = (3.0 - 2.0 * y) * y * y
    visc = visc + (0.5 * R * h * S * vorticity_coeff * (1.0 - step))

    st00 = -P + visc * s00
    st11 = -P + visc * s11
    st22 = -P + visc * s22
    st01 = visc * s01
    st02 = visc * s02
    st12 = visc * s12
    return _finish(J9, (st00, st11, st22, st01, st02, st12), visc / R, Jinv,
                   detJ, S, winv, h1order=h1order, cfl=cfl)


def _finish(J9, st, vR, Jinv, detJ, S, winv, *, h1order, cfl):
    """Shared tail: min-SV dt estimate + stressJinvT assembly."""
    (j00, j01, j02, j10, j11, j12, j20, j21, j22) = J9.unbind(0)
    st00, st11, st22, st01, st02, st12 = st

    # min singular value of J via eigenvalues of J^T J (values only)
    t00 = j00 * j00 + j10 * j10 + j20 * j20
    t11 = j01 * j01 + j11 * j11 + j21 * j21
    t22 = j02 * j02 + j12 * j12 + j22 * j22
    t01 = j00 * j01 + j10 * j11 + j20 * j21
    t02 = j00 * j02 + j10 * j12 + j20 * j22
    t12 = j01 * j02 + j11 * j12 + j21 * j22
    lam, _ = eig3s_hybrid(t00, t11, t22, t01, t02, t12, want_vector=False)
    sv = torch.sqrt(torch.maximum(lam, torch.zeros_like(lam)))

    one = torch.ones_like(sv)
    h_min = sv / h1order
    ih = one / h_min
    idt = S * ih + 2.5 * vR * ih * ih
    inf = torch.full_like(sv, float("inf"))
    pos = idt > 0.0
    dtq = torch.where(pos, cfl / torch.where(pos, idt, one), inf)
    # inverted elements reject the step (laghos_solver.cpp:1144-1148);
    # non-finite q-data must reject it the same way, not read as dt = inf
    good = torch.isfinite(detJ) & (detJ >= 0.0) & ~torch.isnan(idt)
    dtq = torch.where(good, dtq, torch.zeros_like(sv))

    # sJit[gd][vd] = sum_k stress[vd][k] Jinv[gd][k] * w * detJ
    wd = detJ / winv
    stress = ((st00, st01, st02), (st01, st11, st12), (st02, st12, st22))
    sJit = [(stress[vd][0] * Jinv[gd][0] + stress[vd][1] * Jinv[gd][1]
             + stress[vd][2] * Jinv[gd][2]) * wd
            for gd in range(3) for vd in range(3)]
    return torch.stack(sJit), dtq


def _check(J9, dV9, J0i9, e_q, rw, gamma, winv, use_viscosity):
    if e_q.dim() != 2:
        raise ValueError(f"e_q must be (NE, NQ), got {tuple(e_q.shape)}")
    NE, NQ = e_q.shape
    want = {"J9": (J9, (9, NE, NQ)), "J0i9": (J0i9, (9, NE, NQ)),
            "e_q": (e_q, (NE, NQ)), "rw": (rw, (NE, NQ)),
            "gamma": (gamma, (NE,)), "winv": (winv, (NQ,))}
    if use_viscosity:
        want["dV9"] = (dV9, (9, NE, NQ))
    dtype, device = J9.dtype, J9.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"physics_3d takes float32 or float64, got {dtype}")
    for name, (t, shape) in want.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.dtype != dtype or t.device != device:
            raise TypeError(f"{name} is {t.dtype} on {t.device}; all "
                            f"inputs must be {dtype} on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def physics_3d(J9, dV9, J0i9, e_q, rw, gamma, winv, *, h0_e, h1order, cfl,
               use_viscosity=True, use_vorticity=False):
    """Pointwise 3D q-point physics.

    J9, dV9, J0i9: (9, NE, NQ) Jacobian, reference velocity gradient and
    initial inverse Jacobian (dV9 may be None when use_viscosity is
    False); e_q, rw (= rho0 detJ0 w): (NE, NQ); gamma: (NE,);
    winv = 1/w: (NQ,); h0_e, h1order, cfl: Python floats.
    Returns (sJit (9, NE, NQ), dtq (NE, NQ)).

    CPU tensors run `physics_3d_plain`; CUDA tensors launch the CUDA
    kernel, counted in `physics_3d.launches`.
    """
    _check(J9, dV9, J0i9, e_q, rw, gamma, winv, use_viscosity)
    kw = dict(h0_e=float(h0_e), h1order=float(h1order), cfl=float(cfl),
              use_viscosity=use_viscosity, use_vorticity=use_vorticity)
    if J9.device.type == "cpu":
        return physics_3d_plain(J9, dV9, J0i9, e_q, rw, gamma, winv, **kw)
    if J9.device.type != "cuda":
        raise NotImplementedError(f"no physics_3d kernel for {J9.device}")
    sJit = torch.empty_like(J9)
    dtq = torch.empty_like(e_q)
    kernels.launch_qphys(
        J9, dV9 if use_viscosity else J9, J0i9, e_q, rw, gamma, winv, sJit,
        dtq, h0=kw["h0_e"], h1order=kw["h1order"], cfl=kw["cfl"],
        use_viscosity=use_viscosity, use_vorticity=use_vorticity)
    physics_3d.launches += 1
    return sJit, dtq


physics_3d.launches = 0
