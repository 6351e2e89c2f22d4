"""Vectorized small dense-matrix helpers (det, inverse, sym-eig, min SV).

Equivalents of the mfem::kernels device helpers used by the reference's
quadrature-point physics (laghos_solver.cpp:1078-1158), written as
elementwise torch ops in closed form.  Only what the port calls: the 1D
and 2D closed forms, the 3D determinant and the scalarized 3D eigen-solve
`eig3s_hybrid`.

Every function keeps the operation order of `laghos_tpu.ops.smallmat`, and
`torch.maximum`/`torch.minimum` propagate NaN as `jnp.maximum`/`jnp.minimum`
do, so non-finite points take the same branches.

Matrix index convention: A[..., a, b] with a the row.  For Jacobians,
J[..., a, b] = dx_a/dxhat_b.
"""

from __future__ import annotations

import torch

_EPS64 = 2.0 ** -52


def det(J: torch.Tensor, d: int) -> torch.Tensor:
    """Determinant of dxd batches in closed form (the 3D q-update computes
    its own inside the fused q-point physics)."""
    if d == 1:
        return J[..., 0, 0]
    if d == 2:
        return J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
    a, b, c = J[..., 0, 0], J[..., 0, 1], J[..., 0, 2]
    p, q, r = J[..., 1, 0], J[..., 1, 1], J[..., 1, 2]
    u, v, w = J[..., 2, 0], J[..., 2, 1], J[..., 2, 2]
    return a * (q * w - r * v) - b * (p * w - r * u) + c * (p * v - q * u)


def inv(J: torch.Tensor, d: int, detJ=None) -> torch.Tensor:
    """Inverse of 1x1 and 2x2 batches (2x2 by the adjugate)."""
    if d not in (1, 2):
        raise NotImplementedError("inv is the 1D and 2D closed form")
    if detJ is None:
        detJ = det(J, d)
    idet = 1.0 / detJ
    if d == 1:
        return idet[..., None, None]
    r0 = torch.stack([J[..., 1, 1], -J[..., 0, 1]], dim=-1)
    r1 = torch.stack([-J[..., 1, 0], J[..., 0, 0]], dim=-1)
    return torch.stack([r0, r1], dim=-2) * idet[..., None, None]


def _eig2_smallest(A: torch.Tensor):
    """Smallest eigenvalue + its eigenvector of symmetric 2x2 batches
    (mfem::kernels::CalcEigenvalues<2>, Parlett's rotation)."""
    lam_min, vx, vy = eig2_smallest_scalar(
        A[..., 0, 0], A[..., 1, 1], A[..., 0, 1])
    return lam_min, torch.stack([vx, vy], dim=-1)


def sym_eig_smallest(A: torch.Tensor, d: int):
    """(lambda_min, eigenvector) of symmetric 1x1 and 2x2 batches."""
    if d == 1:
        return A[..., 0, 0], torch.ones_like(A[..., 0, :])
    return _eig2_smallest(A)


def min_singular_value(J: torch.Tensor, d: int) -> torch.Tensor:
    """Smallest singular value of 1x1 and 2x2 batches
    (mfem kernels::CalcSingularvalue)."""
    if d == 1:
        return torch.abs(J[..., 0, 0])
    return min_sv2_scalar(J[..., 0, 0], J[..., 0, 1], J[..., 1, 0],
                          J[..., 1, 1])


def _sign(x):
    """`jnp.sign`: NaN stays NaN (`torch.sign` maps it to 0)."""
    return torch.where(torch.isnan(x), x, torch.sign(x))


def eig2_smallest_scalar(d1, d2, d12):
    """Scalar-component form of _eig2_smallest: (lam_min, vx, vy),
    including the d12 == 0 tie-break with vec = (1, 0) when
    d1 <= d2."""
    one = torch.ones_like(d12)
    zero = torch.zeros_like(d12)
    sqrt_1_eps = (1.0 / _EPS64) ** 0.5
    isdiag = d12 == 0.0
    zeta = (d2 - d1) / (2.0 * torch.where(isdiag, one, d12))
    azeta = torch.abs(zeta)
    t_small = _sign(zeta) / (azeta + torch.sqrt(1.0 + zeta * zeta))
    t_small = torch.where(zeta == 0.0, one, t_small)  # copysign(.,0)=+
    t_big = _sign(zeta) * (0.5 / azeta)
    t = torch.where(azeta < sqrt_1_eps, t_small, t_big)
    c = torch.sqrt(1.0 / (1.0 + t * t))
    s = c * t
    shift = t * d12
    e1 = d1 - shift
    e2 = d2 + shift
    # d12 == 0 -> identity rotation
    c = torch.where(isdiag, one, c)
    s = torch.where(isdiag, zero, s)
    e1 = torch.where(isdiag, d1, e1)
    e2 = torch.where(isdiag, d2, e2)
    first = e1 <= e2
    lam_min = torch.where(first, e1, e2)
    vx = torch.where(first, c, s)
    vy = torch.where(first, -s, c)
    return lam_min, vx, vy


def _hypot(x1, x2):
    """hypot in the operation order of `jnp.hypot` (scaled by the larger
    leg), so 2D dt estimates round as in the JAX package."""
    x1, x2 = torch.abs(x1), torch.abs(x2)
    idx_inf = torch.isposinf(x1) | torch.isposinf(x2)
    x1, x2 = torch.maximum(x1, x2), torch.minimum(x1, x2)
    safe = torch.where(x1 == 0, torch.ones_like(x1), x1)
    r = x2 / safe
    x = torch.where(x1 == 0, x1, x1 * torch.sqrt(1 + r * r))
    return torch.where(idx_inf, torch.full_like(x, float("inf")), x)


def min_sv2_scalar(a, b, c, dd):
    """2x2 smallest singular value in stable closed form: with
    E,F = (a±d)/2 and G,H = (c±b)/2 the singular values are |Q±R| for
    Q = |(E,H)|, R = |(F,G)|."""
    E = (a + dd) / 2.0
    F = (a - dd) / 2.0
    G = (c + b) / 2.0
    H = (c - b) / 2.0
    Q = _hypot(E, H)
    R = _hypot(F, G)
    return torch.abs(Q - R)


def _jacobi_rotation(app, aqq, apq):
    """Stable (c, s, t) annihilating the (p,q) entry (Golub & Van Loan),
    with t = tan(theta) for the exact diagonal update (GvL 8.4).  A zero
    or non-finite rotation angle skips the rotation."""
    one = torch.ones_like(apq)
    zero = torch.zeros_like(apq)
    nonzero = apq != 0.0
    safe = torch.where(nonzero, apq, one)
    tau = (aqq - app) / (2.0 * safe)
    ok = nonzero & torch.isfinite(tau)
    sgn = torch.where(tau >= 0.0, one, -one)
    tau_s = torch.where(ok, tau, zero)
    t = sgn / (torch.abs(tau_s) + torch.sqrt(one + tau_s * tau_s))
    c = one / torch.sqrt(one + t * t)
    s = t * c
    c = torch.where(ok, c, one)
    s = torch.where(ok, s, zero)
    t = torch.where(ok, t, zero)
    return c, s, t


def jacobi_rot_step(app, aqq, apq, arp, arq):
    """One guarded Jacobi rotation in the (p,q) plane; r = third index.

    Returns (app', aqq', apq', arp', arq', c, s) with apq' = 0 for an
    applied rotation.  Rotations whose updates come out NaN are skipped
    (identity, apq kept)."""
    c, s, t = _jacobi_rotation(app, aqq, apq)
    app_n = app - t * apq
    aqq_n = aqq + t * apq
    arp_n = c * arp - s * arq
    arq_n = s * arp + c * arq
    bad = (torch.isnan(app_n) | torch.isnan(aqq_n) | torch.isnan(arp_n)
           | torch.isnan(arq_n))
    one = torch.ones_like(c)
    zero = torch.zeros_like(s)
    return (torch.where(bad, app, app_n), torch.where(bad, aqq, aqq_n),
            torch.where(bad, apq, zero),
            torch.where(bad, arp, arp_n), torch.where(bad, arq, arq_n),
            torch.where(bad, one, c), torch.where(bad, zero, s))


def _sweeps_f32(a00, a11, a22, a01, a02, a12, sweeps):
    """Cyclic Jacobi in float32 with accumulated rotations.
    Returns (d0, d1, d2, V[3][3]) in float32."""
    f32 = torch.float32
    a00, a11, a22, a01, a02, a12 = (x.to(f32) for x in
                                    (a00, a11, a22, a01, a02, a12))
    one = torch.ones_like(a00)
    zero = torch.zeros_like(a00)
    V = [[one, zero, zero], [zero, one, zero], [zero, zero, one]]

    def vupd(c, s, p, q):
        for i in range(3):
            vip, viq = V[i][p], V[i][q]
            V[i][p] = c * vip - s * viq
            V[i][q] = s * vip + c * viq

    for _ in range(sweeps):
        a00, a11, a01, a02, a12, c, s = jacobi_rot_step(
            a00, a11, a01, a02, a12)
        vupd(c, s, 0, 1)
        a00, a22, a02, a01, a12, c, s = jacobi_rot_step(
            a00, a22, a02, a01, a12)
        vupd(c, s, 0, 2)
        a11, a22, a12, a01, a02, c, s = jacobi_rot_step(
            a11, a22, a12, a01, a02)
        vupd(c, s, 1, 2)
    return a00, a11, a22, V


def _pick_smallest_f32(d0, d1, d2, V):
    m01 = d0 <= d1
    mu01 = torch.where(m01, d0, d1)
    mu32 = torch.minimum(mu01, d2)
    p0 = m01 & (d0 <= d2)
    p1 = (~m01) & (d1 <= d2)
    vx = torch.where(p0, V[0][0], torch.where(p1, V[0][1], V[0][2]))
    vy = torch.where(p0, V[1][0], torch.where(p1, V[1][1], V[1][2]))
    vz = torch.where(p0, V[2][0], torch.where(p1, V[2][1], V[2][2]))
    return mu32, vx, vy, vz


def eig3s_hybrid(a00, a11, a22, a01, a02, a12, *, sweeps=4,
                 want_vector=True):
    """Smallest eigenpair of scalarized symmetric 3x3 batches.

    Jacobi sweeps run in float32 (angle error ~eps32); refinements in the
    input precision then square the error:
      * value: Rayleigh quotient of the f32 vector;
      * vector: u = adj(A - mu I) . v32 -- one inverse-iteration step
        without the near-singular division; degenerate spectra (adj ~ 0)
        keep the f32 vector (mfem kernels CalcEigenvalues<3> leaves the
        direction within a repeated eigenvalue free as well);
      * a second Rayleigh quotient on the refined vector.
    For float32 inputs the refinements run in float32."""
    dt = a00.dtype
    d0, d1, d2, V = _sweeps_f32(a00, a11, a22, a01, a02, a12, sweeps)
    mu32, vx32, vy32, vz32 = _pick_smallest_f32(d0, d1, d2, V)
    vx, vy, vz = (v.to(dt) for v in (vx32, vy32, vz32))

    def rayleigh(x, y, z):
        Ax = a00 * x + a01 * y + a02 * z
        Ay = a01 * x + a11 * y + a12 * z
        Az = a02 * x + a12 * y + a22 * z
        num = x * Ax + y * Ay + z * Az
        den = x * x + y * y + z * z
        return num / torch.where(den == 0.0, torch.ones_like(den), den)

    mu = rayleigh(vx, vy, vz)
    ok = torch.isfinite(mu)
    mu = torch.where(ok, mu, mu32.to(dt))
    if not want_vector:
        return mu, None

    # adjugate null-space step: u = adj(A - mu I) . v
    b00 = a00 - mu
    b11 = a11 - mu
    b22 = a22 - mu
    c00 = b11 * b22 - a12 * a12
    c01 = a02 * a12 - a01 * b22
    c02 = a01 * a12 - a02 * b11
    c11 = b00 * b22 - a02 * a02
    c12 = a01 * a02 - b00 * a12
    c22 = b00 * b11 - a01 * a01
    ux = c00 * vx + c01 * vy + c02 * vz
    uy = c01 * vx + c11 * vy + c12 * vz
    uz = c02 * vx + c12 * vy + c22 * vz
    nu2 = ux * ux + uy * uy + uz * uz
    m = torch.maximum(torch.maximum(torch.abs(a00), torch.abs(a11)),
                      torch.maximum(torch.abs(a22), torch.abs(a01)))
    m = torch.maximum(m, torch.maximum(torch.abs(a02), torch.abs(a12)))
    # adj entries scale as m^2 * (relative eigen-gaps); below ~1e-6 the
    # cluster direction is arbitrary -- keep the f32 vector
    tol = torch.tensor(1e-6, dtype=dt, device=a00.device)
    q = tol * m * m
    good = (nu2 > q * q) & torch.isfinite(nu2)
    one = torch.ones_like(nu2)
    inu = one / torch.sqrt(torch.where(good, nu2, one))
    ex = torch.where(good, ux * inu, vx)
    ey = torch.where(good, uy * inu, vy)
    ez = torch.where(good, uz * inu, vz)
    mu2 = rayleigh(ex, ey, ez)
    mu = torch.where(good & torch.isfinite(mu2), mu2, mu)
    return mu, (ex, ey, ez)
