"""Pointwise quadrature physics of the q-update.

The q-update splits into (a) interpolation (sum-factorized, ops/tensor.py,
or banded on the lattice, ops/lattice.py) and (b) a purely pointwise
physics chain: EOS, artificial viscosity, the eigen-solves and the dt
estimate.  This module is (b), the reference's QUpdateBody
(laghos_solver.cpp:1042-1168), in three memory layouts of one 3D kernel
(`csrc/qphys.cu`) plus the plain 2D version:

* `physics_3d` -- element layout: (9, NE, NQ) component stacks, gamma per
  element (NE,), 1/w per q-point (NQ,).  The gather path's q-update.
* `physics_3d_lattice` -- q-lattice layout: (9, *S) stacks of same-shape
  fields of any shape S, gamma and 1/w per point, h0 a scalar.  The
  whole-lattice q-update (ops/lattice.qupdate3d_lattice).
* `physics_3d_packed` -- packed layout: (NE, NQ, 3, 3) matrices, gamma
  (NE,), the weights W (NQ,); also returns the viscosity coefficient.
* `physics_2d` -- the 2D whole-lattice physics, plain torch (the JAX
  package has no 2D kernel either).

Each 3D entry point runs its plain torch version (`*_plain`, the line-by-
line translation of `laghos_tpu.ops.qphys.physics_3d` + `_finish`) for CPU
tensors and launches the CUDA kernel for CUDA tensors, counting launches
in its own `launches` attribute; any other device raises.  Component k of
a 3x3 field is [a][b] with k = 3a + b, as in the JAX package's 9-tuples.
"""

from __future__ import annotations

import torch

from . import kernels
from .smallmat import eig2_smallest_scalar, eig3s_hybrid, min_sv2_scalar


def _physics_3d(J, dV, J0i, e_q, rw, gamma, winv, *, h0, h1order, cfl,
                use_viscosity, use_vorticity):
    """The chain on sequences of 9 broadcast-compatible point fields.
    Returns (sJit list of 9 [gd*3+vd], dtq, visc)."""
    (j00, j01, j02, j10, j11, j12, j20, j21, j22) = J
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
        sJit, dtq = _finish(J, (-P, -P, -P, zero, zero, zero), zero, Jinv,
                            detJ, S, winv, h1order=h1order, cfl=cfl)
        return sJit, dtq, zero

    # sgrad = dV . Jinv (physical velocity gradient)
    (d00, d01, d02, d10, d11, d12, d20, d21, d22) = dV
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
    (o00, o01, o02, o10, o11, o12, o20, o21, o22) = J0i
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
    h = (h0 * torch.sqrt(phx * phx + phy * phy + phz * phz)
         / torch.sqrt(ex * ex + ey * ey + ez * ez))

    visc = 2.0 * R * h * h * torch.abs(mu)
    visc = visc + (0.5 * R * h * S * vorticity_coeff
                   * (1.0 - _smooth_step(mu)))

    st00 = -P + visc * s00
    st11 = -P + visc * s11
    st22 = -P + visc * s22
    st01 = visc * s01
    st02 = visc * s02
    st12 = visc * s12
    sJit, dtq = _finish(J, (st00, st11, st22, st01, st02, st12), visc / R,
                        Jinv, detJ, S, winv, h1order=h1order, cfl=cfl)
    return sJit, dtq, visc


def _smooth_step(mu):
    """C1 ramp 0->1 over [-eps, eps] at mu - 2 eps, eps = 1e-12
    (laghos_solver.cpp:798-805), clipped as jnp.clip."""
    eps = 1e-12
    y = (mu - 2.0 * eps + eps) / (2.0 * eps)
    y = torch.minimum(torch.maximum(y, torch.zeros_like(y)),
                      torch.ones_like(y))
    return (3.0 - 2.0 * y) * y * y


def _dt_points(S, vR, sv, detJ, h1order, cfl):
    """Per-point CFL dt; 0 where the point is inverted or not finite."""
    one = torch.ones_like(sv)
    h_min = sv / h1order
    ih = one / h_min
    idt = S * ih + 2.5 * vR * ih * ih
    pos = idt > 0.0
    dtq = torch.where(pos, cfl / torch.where(pos, idt, one),
                      torch.full_like(sv, float("inf")))
    # inverted elements reject the step (laghos_solver.cpp:1144-1148);
    # non-finite q-data must reject it the same way, not read as dt = inf
    good = torch.isfinite(detJ) & (detJ >= 0.0) & ~torch.isnan(idt)
    return torch.where(good, dtq, torch.zeros_like(sv))


def _finish(J, st, vR, Jinv, detJ, S, winv, *, h1order, cfl):
    """Shared tail: min-SV dt estimate + stressJinvT assembly."""
    (j00, j01, j02, j10, j11, j12, j20, j21, j22) = J
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
    dtq = _dt_points(S, vR, sv, detJ, h1order, cfl)

    # sJit[gd][vd] = sum_k stress[vd][k] Jinv[gd][k] * w * detJ
    wd = detJ / winv
    stress = ((st00, st01, st02), (st01, st11, st12), (st02, st12, st22))
    sJit = [(stress[vd][0] * Jinv[gd][0] + stress[vd][1] * Jinv[gd][1]
             + stress[vd][2] * Jinv[gd][2]) * wd
            for gd in range(3) for vd in range(3)]
    return sJit, dtq


def _split(A9, use):
    return A9.unbind(0) if use else None


def physics_3d_plain(J9, dV9, J0i9, e_q, rw, gamma, winv, *, h0_e, h1order,
                     cfl, use_viscosity=True, use_vorticity=False):
    """Plain torch version of the element-layout kernel; same arguments
    and results as `physics_3d`."""
    sJit, dtq, _ = _physics_3d(
        J9.unbind(0), _split(dV9, use_viscosity), J0i9.unbind(0), e_q, rw,
        gamma[:, None], winv[None, :], h0=h0_e, h1order=h1order, cfl=cfl,
        use_viscosity=use_viscosity, use_vorticity=use_vorticity)
    return torch.stack(sJit), dtq


def physics_3d_lattice_plain(J9, dV9, J0i9, e_q, rw, gam, winv, *, h0,
                             h1order, cfl, use_viscosity=True,
                             use_vorticity=False):
    """Plain torch version of the lattice-layout kernel; same arguments
    and results as `physics_3d_lattice`."""
    sJit, dtq, _ = _physics_3d(
        J9.unbind(0), _split(dV9, use_viscosity), J0i9.unbind(0), e_q, rw,
        gam, winv, h0=h0, h1order=h1order, cfl=cfl,
        use_viscosity=use_viscosity, use_vorticity=use_vorticity)
    return torch.stack(sJit), dtq


def physics_3d_packed_plain(J, dV, J0i, e_q, rw, gamma, W, *, h0, h1order,
                            cfl, use_viscosity=True, use_vorticity=False):
    """Plain torch version of the packed-layout kernel; same arguments
    and results as `physics_3d_packed`."""
    NE, NQ = e_q.shape

    def comps(A):
        return A.reshape(NE, NQ, 9).unbind(-1)

    sJit, dtq, visc = _physics_3d(
        comps(J), comps(dV) if use_viscosity else None, comps(J0i), e_q,
        rw, gamma[:, None], (1.0 / W)[None, :], h0=h0, h1order=h1order,
        cfl=cfl, use_viscosity=use_viscosity, use_vorticity=use_vorticity)
    return torch.stack(sJit, dim=-1).reshape(NE, NQ, 3, 3), dtq, visc


def _check(name, want, use_viscosity):
    """Dtype, device, shape and contiguity of the inputs of one entry
    point; `want` maps argument names to (tensor, shape), "dV" entries
    only when `use_viscosity`."""
    first = next(iter(want.values()))[0]
    dtype, device = first.dtype, first.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name} takes float32 or float64, got {dtype}")
    for arg, (t, shape) in want.items():
        if arg.startswith("dV") and not use_viscosity:
            continue
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{arg} must be a tensor")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{arg} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if t.dtype != dtype or t.device != device:
            raise TypeError(f"{arg} is {t.dtype} on {t.device}; all "
                            f"inputs must be {dtype} on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{arg} must be contiguous")
    if device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no {name} kernel for {device}")
    return device.type == "cuda"


def _run(entry, layout, plain, args, want, outs, *, NQ, h0, h0_arg, kw):
    """Shared body of the 3D entry points: check the inputs (`want` as in
    `_check`), run `plain` for CPU tensors, else launch the kernel in
    `layout` into the tensors `outs()` allocates ((sJit, dtq) or
    (sJit, dtq, visc)), count the launch on `entry` and return them."""
    kw = dict(h1order=float(kw["h1order"]), cfl=float(kw["cfl"]),
              use_viscosity=kw["use_viscosity"],
              use_vorticity=kw["use_vorticity"])
    if not _check(entry.__name__, want, kw["use_viscosity"]):
        return plain(*args, **{h0_arg: float(h0)}, **kw)
    res = outs()
    sJit, dtq, visc = res + (None,) * (3 - len(res))
    kernels.launch_qphys(layout, *args, sJit, dtq, visc, NQ=NQ,
                         h0=float(h0), **kw)
    entry.launches += 1
    return res


def physics_3d(J9, dV9, J0i9, e_q, rw, gamma, winv, *, h0_e, h1order, cfl,
               use_viscosity=True, use_vorticity=False):
    """Pointwise 3D q-point physics, element layout.

    J9, dV9, J0i9: (9, NE, NQ) Jacobian, reference velocity gradient and
    initial inverse Jacobian (dV9 may be None when use_viscosity is
    False); e_q, rw (= rho0 detJ0 w): (NE, NQ); gamma: (NE,);
    winv = 1/w: (NQ,); h0_e, h1order, cfl: Python floats.
    Returns (sJit (9, NE, NQ), dtq (NE, NQ)).
    """
    if e_q.dim() != 2:
        raise ValueError(f"e_q must be (NE, NQ), got {tuple(e_q.shape)}")
    NE, NQ = e_q.shape
    return _run(
        physics_3d, kernels.ELEMENT, physics_3d_plain,
        (J9, dV9, J0i9, e_q, rw, gamma, winv),
        {"J9": (J9, (9, NE, NQ)), "dV9": (dV9, (9, NE, NQ)),
         "J0i9": (J0i9, (9, NE, NQ)), "e_q": (e_q, (NE, NQ)),
         "rw": (rw, (NE, NQ)), "gamma": (gamma, (NE,)),
         "winv": (winv, (NQ,))},
        lambda: (torch.empty_like(J9), torch.empty_like(e_q)),
        NQ=NQ, h0=h0_e, h0_arg="h0_e", kw=dict(
            h1order=h1order, cfl=cfl, use_viscosity=use_viscosity,
            use_vorticity=use_vorticity))


def physics_3d_lattice(J9, dV9, J0i9, e_q, rw, gam, winv, *, h0, h1order,
                       cfl, use_viscosity=True, use_vorticity=False):
    """Pointwise 3D q-point physics, q-lattice layout.

    e_q, rw, gam, winv: same-shape point fields of any shape S (gamma and
    1/w per point); J9, dV9, J0i9: (9, *S) stacks (dV9 may be None when
    use_viscosity is False); h0, h1order, cfl: Python floats.
    Returns (sJit (9, *S), dtq S).
    """
    S = tuple(e_q.shape)
    return _run(
        physics_3d_lattice, kernels.LATTICE, physics_3d_lattice_plain,
        (J9, dV9, J0i9, e_q, rw, gam, winv),
        {"J9": (J9, (9,) + S), "dV9": (dV9, (9,) + S),
         "J0i9": (J0i9, (9,) + S), "e_q": (e_q, S), "rw": (rw, S),
         "gam": (gam, S), "winv": (winv, S)},
        lambda: (torch.empty_like(J9), torch.empty_like(e_q)),
        NQ=1, h0=h0, h0_arg="h0", kw=dict(
            h1order=h1order, cfl=cfl, use_viscosity=use_viscosity,
            use_vorticity=use_vorticity))


def physics_3d_packed(J, dV, J0i, e_q, rw, gamma, W, *, h0, h1order, cfl,
                      use_viscosity=True, use_vorticity=False):
    """Pointwise 3D q-point physics, packed layout.

    J, dV, J0i: (NE, NQ, 3, 3) (dV may be None when use_viscosity is
    False); e_q, rw: (NE, NQ); gamma: (NE,); W: the quadrature weights
    (NQ,); h0, h1order, cfl: Python floats.
    Returns (sJit (NE, NQ, 3, 3), dtq (NE, NQ), visc (NE, NQ)).
    """
    if e_q.dim() != 2:
        raise ValueError(f"e_q must be (NE, NQ), got {tuple(e_q.shape)}")
    NE, NQ = e_q.shape
    return _run(
        physics_3d_packed, kernels.PACKED, physics_3d_packed_plain,
        (J, dV, J0i, e_q, rw, gamma, W),
        {"J": (J, (NE, NQ, 3, 3)), "dV": (dV, (NE, NQ, 3, 3)),
         "J0i": (J0i, (NE, NQ, 3, 3)), "e_q": (e_q, (NE, NQ)),
         "rw": (rw, (NE, NQ)), "gamma": (gamma, (NE,)), "W": (W, (NQ,))},
        lambda: (torch.empty_like(J), torch.empty_like(e_q),
                 torch.empty_like(e_q)),
        NQ=NQ, h0=h0, h0_arg="h0", kw=dict(
            h1order=h1order, cfl=cfl, use_viscosity=use_viscosity,
            use_vorticity=use_vorticity))


physics_3d.launches = 0
physics_3d_lattice.launches = 0
physics_3d_packed.launches = 0


def physics_2d(J, dV, J0i, e_q, rw, gamma, winv, *, h0_e, h1order, cfl,
               use_viscosity=True, use_vorticity=False):
    """2D pointwise physics of the whole-lattice q-update
    (`laghos_tpu.ops.qphys.physics_2d`), plain torch.

    J, dV, J0i: sequences of 4 same-shape point fields, row-major [a][b]
    with b = 0 the x direction (dV may be None when use_viscosity is
    False); e_q, rw, gamma, winv: point fields; h0_e a float or a field.
    Returns (sJit list of 4 [gd*2+vd], dtq, visc).
    """
    (j00, j01, j10, j11) = J
    detJ = j00 * j11 - j01 * j10
    idet = 1.0 / detJ
    i00, i01 = j11 * idet, -j01 * idet
    i10, i11 = -j10 * idet, j00 * idet

    R = rw * winv * idet
    E = torch.maximum(torch.zeros_like(e_q), e_q)
    P = (gamma - 1.0) * R * E
    S = torch.sqrt(gamma * (gamma - 1.0) * E)

    visc = torch.zeros_like(R)
    st00 = -P
    st11 = -P
    st01 = torch.zeros_like(P)
    if use_viscosity:
        (d00, d01, d10, d11) = dV
        # physical velocity gradient sgrad = dV . Jinv
        g00 = d00 * i00 + d01 * i10
        g01 = d00 * i01 + d01 * i11
        g10 = d10 * i00 + d11 * i10
        g11 = d10 * i01 + d11 * i11

        vorticity_coeff = 1.0
        if use_vorticity:
            fro = torch.sqrt(g00 * g00 + g01 * g01 + g10 * g10 + g11 * g11)
            div = torch.abs(g00 + g11)
            vorticity_coeff = torch.where(
                fro > 0.0, div / torch.maximum(fro,
                                               torch.full_like(fro, 1e-300)),
                torch.ones_like(fro))

        s00, s11 = g00, g11
        s01 = 0.5 * (g01 + g10)
        mu, ex, ey = eig2_smallest_scalar(s00, s11, s01)

        # Jpi = J . Jac0inv; ph = Jpi . e
        (o00, o01, o10, o11) = J0i
        p00 = j00 * o00 + j01 * o10
        p01 = j00 * o01 + j01 * o11
        p10 = j10 * o00 + j11 * o10
        p11 = j10 * o01 + j11 * o11
        phx = p00 * ex + p01 * ey
        phy = p10 * ex + p11 * ey
        h = (h0_e * torch.sqrt(phx * phx + phy * phy)
             / torch.sqrt(ex * ex + ey * ey))

        visc = 2.0 * R * h * h * torch.abs(mu)
        visc = visc + (0.5 * R * h * S * vorticity_coeff
                       * (1.0 - _smooth_step(mu)))

        st00 = st00 + visc * s00
        st11 = st11 + visc * s11
        st01 = visc * s01

    # dt estimate from the smallest singular value of J
    sv = min_sv2_scalar(j00, j01, j10, j11)
    dtq = _dt_points(S, visc / R, sv, detJ, h1order, cfl)

    # sJit[gd*2+vd] = sum_k stress[vd,k] Jinv[gd,k] * w * detJ
    wd = detJ / winv
    stress = ((st00, st01), (st01, st11))
    Jinv = ((i00, i01), (i10, i11))
    sJit = [(stress[vd][0] * Jinv[gd][0] + stress[vd][1] * Jinv[gd][1]) * wd
            for gd in range(2) for vd in range(2)]
    return sJit, dtq, visc
