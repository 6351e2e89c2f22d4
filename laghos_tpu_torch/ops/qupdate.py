"""Quadrature-point update: EOS, artificial viscosity, dt estimate, stress.

The reference's QUpdate kernel (laghos_solver.cpp:1042-1168, QUpdateBody)
as batched tensor algebra over the (element, qpoint) axes.

Physics (ideal gas, cf. laghos_solver.hpp:151-160):
    p  = (gamma - 1) rho e,    cs = sqrt(gamma (gamma-1) e)
with the tensor artificial viscosity of Dobrev/Kolev/Rieben built from the
eigen-decomposition of the symmetrized velocity gradient.

`qupdate` is the 2D path (plain torch); `qupdate3d` feeds the scalarized 3D
fields to `qphys.physics_3d`, which launches the CUDA kernel on the card.
"""

from __future__ import annotations

import torch

from . import qphys, smallmat, tensor


def smooth_step_01(x, eps):
    """C1 ramp 0->1 over [-eps, eps] (laghos_solver.cpp:798-805)."""
    y = (x + eps) / (2.0 * eps)
    y = torch.minimum(torch.maximum(y, torch.zeros_like(y)),
                      torch.ones_like(y))
    return (3.0 - 2.0 * y) * y * y


def qupdate(
    x_e,            # (NE, dim, nd1^d) H1 positions, element layout
    v_e,            # (NE, dim, nd1^d) H1 velocities
    e_b,            # (NE, l1d^d) L2 energy (Bernstein coeffs)
    gamma,          # (NE,)
    rho0DetJ0w,     # (NE, NQ)
    Jac0inv,        # (NE, NQ, d, d)
    tables,         # dict of basis tables (H1B,H1G,L2B) + weights W
    h0,             # float
    *,
    dim: int,
    h1order: float,
    cfl: float,
    use_viscosity: bool,
    use_vorticity: bool,
):
    """2D q-update: returns (stressJinvT (NE,NQ,2,2) indexed [gd,vd],
    dt_est 0-d tensor).

    The per-point dt estimate replicates laghos_solver.cpp:1135-1156,
    including the detJ<0 -> dt_est=0 step-rejection trigger.
    """
    if dim != 2:
        raise NotImplementedError(
            "qupdate is the 2D path; 3D runs qupdate3d, 1D waits for "
            "ROADMAP A6")
    d = dim
    NE = x_e.shape[0]
    H1B, H1G, L2B, W = (tables["H1B"], tables["H1G"], tables["L2B"],
                        tables["W"])
    nd1 = H1B.shape[1]
    nq1 = H1B.shape[0]
    NQ = nq1**d
    l1d = L2B.shape[1]

    xt = x_e.reshape((NE, d) + (nd1,) * d)
    vt = v_e.reshape((NE, d) + (nd1,) * d)
    # J[e, a, q..., b] = dx_a/dxhat_b
    Jt = tensor.eval_gradient(xt, H1B, H1G, d)     # (NE, d, q..., d)
    J = torch.movedim(Jt.reshape(NE, d, NQ, d), 1, 2)  # (NE, NQ, a, b)
    detJ = smallmat.det(J, d)
    Jinv = smallmat.inv(J, d, detJ)

    et = e_b.reshape((NE,) + (l1d,) * d)
    e_q = tensor.eval_values(et, L2B, d).reshape(NE, NQ)

    R = rho0DetJ0w / (detJ * W[None, :])
    E = torch.maximum(torch.zeros_like(e_q), e_q)
    g = gamma[:, None]
    P = (g - 1.0) * R * E
    S = torch.sqrt(g * (g - 1.0) * E)

    eye = torch.eye(d, dtype=x_e.dtype, device=x_e.device)
    stress = -P[..., None, None] * eye

    visc_coeff = torch.zeros_like(R)
    if use_viscosity:
        dVt = tensor.eval_gradient(vt, H1B, H1G, d)
        dV = torch.movedim(dVt.reshape(NE, d, NQ, d), 1, 2)  # dv_a/dxhat_b
        sgrad = torch.einsum("...ab,...bk->...ak", dV, Jinv)  # physical grad

        vorticity_coeff = 1.0
        if use_vorticity:
            grad_norm = torch.sqrt(torch.sum(sgrad * sgrad, dim=(-2, -1)))
            div_v = torch.abs(torch.einsum("...aa->...", sgrad))
            vorticity_coeff = torch.where(
                grad_norm > 0.0,
                div_v / torch.maximum(grad_norm,
                                      torch.full_like(grad_norm, 1e-300)),
                torch.ones_like(grad_norm))

        sym = 0.5 * (sgrad + torch.swapaxes(sgrad, -2, -1))
        mu, compr_dir = smallmat._eig2_smallest(sym)
        Jpi = torch.einsum("...ab,...bk->...ak", J, Jac0inv)
        ph_dir = torch.einsum("...ab,...b->...a", Jpi, compr_dir)
        h = (h0 * torch.sqrt(torch.sum(ph_dir * ph_dir, dim=-1))
             / torch.sqrt(torch.sum(compr_dir * compr_dir, dim=-1)))
        visc_coeff = 2.0 * R * h * h * torch.abs(mu)
        eps = 1e-12
        visc_coeff = visc_coeff + (
            0.5 * R * h * S * vorticity_coeff
            * (1.0 - smooth_step_01(mu - 2.0 * eps, eps)))
        stress = stress + visc_coeff[..., None, None] * sym

    sv = smallmat.min_sv2_scalar(J[..., 0, 0], J[..., 0, 1], J[..., 1, 0],
                                 J[..., 1, 1])
    h_min = sv / h1order
    ih_min = 1.0 / h_min
    idt = S * ih_min + 2.5 * visc_coeff * ih_min * ih_min / R
    one = torch.ones_like(idt)
    pos = idt > 0.0
    dtq = torch.where(pos, cfl / torch.where(pos, idt, one),
                      torch.full_like(idt, float("inf")))
    # reject inverted elements AND non-finite qdata (NaN would slip
    # through the `<` comparison and read as dt = inf)
    good = torch.isfinite(detJ) & (detJ >= 0.0) & ~torch.isnan(idt)
    dtq = torch.where(good, dtq, torch.zeros_like(dtq))

    # stressJinvT[gd, vd] = sum_k stress[vd,k] Jinv[gd,k] * w * detJ
    sJit = torch.einsum("...vk,...gk->...gv", stress, Jinv)
    sJit = sJit * (W[None, :] * detJ)[..., None, None]
    return sJit, torch.min(dtq)


def jacobians(x_e, H1B, H1G, dim):
    """Current-configuration Jacobians at qpoints: (NE, NQ, a, b)."""
    NE = x_e.shape[0]
    nd1 = H1B.shape[1]
    nq1 = H1B.shape[0]
    xt = x_e.reshape((NE, dim) + (nd1,) * dim)
    Jt = tensor.eval_gradient(xt, H1B, H1G, dim)
    return torch.movedim(Jt.reshape(NE, dim, nq1**dim, dim), 1, 2)


def _grad9(u_e, H1B, H1G, nd1, NQ):
    """(NE, 3, nd) element field -> (9, NE, NQ) reference gradient,
    component 3a + b = d u_a / d xhat_b."""
    NE = u_e.shape[0]
    ut = torch.movedim(u_e.reshape((NE, 3) + (nd1,) * 3), 1, 0)
    dirs = [tensor.eval_gradient_dir(ut, H1B, H1G, b, 3).reshape(3, NE, NQ)
            for b in range(3)]
    return torch.stack(dirs, dim=1).reshape(9, NE, NQ)


def qupdate3d(x_e, v_e, e_b, gamma, rho0DetJ0w, Jac0inv9, tables, h0, *,
              h1order, cfl, use_viscosity, use_vorticity, oz=None):
    """Scalarized 3D q-update: returns (sJit (9, NE, NQ), dt_est).

    Same physics as `laghos_tpu.ops.qupdate.qupdate3d` (its sum-factorized
    branch, or with `oz` its Ozaki branch); the 9 components of J, grad v
    and sJit travel stacked on a leading axis.  Jac0inv9 is the matching
    (9, NE, NQ) stack, and tables["Winv"] holds 1/W.  oz = (gcatT, l2_fwd)
    static splits: ONE dynamic split of the stacked (x, v) E-vectors feeds
    all three gradient directions through the column-concatenated dense
    operator.
    """
    d = 3
    NE = x_e.shape[0]
    H1B, H1G, L2B = tables["H1B"], tables["H1G"], tables["L2B"]
    nd1 = H1B.shape[1]
    nq1 = H1B.shape[0]
    NQ = nq1**d
    l1d = L2B.shape[1]

    if oz is not None:
        from . import omm

        gcatT, l2_fwd = oz
        xv = torch.cat([x_e, v_e], dim=1)               # (NE, 2d, nd)
        dxv = omm.matmul(xv, gcatT).reshape(NE, 2 * d, d, NQ)

        def stack9(c0):
            # component 3a + b = d u_{c0+a} / d xhat_b
            return (dxv[:, c0:c0 + d].permute(1, 2, 0, 3)
                    .reshape(9, NE, NQ).contiguous())

        J9 = stack9(0)
        dV9 = stack9(d) if use_viscosity else None
        e_q = omm.matmul(e_b, l2_fwd)
    else:
        J9 = _grad9(x_e, H1B, H1G, nd1, NQ)
        dV9 = _grad9(v_e, H1B, H1G, nd1, NQ) if use_viscosity else None
        et = e_b.reshape((NE,) + (l1d,) * d)
        e_q = tensor.eval_values(et, L2B, d).reshape(NE, NQ)
    sJit9, dtq = qphys.physics_3d(
        J9, dV9, Jac0inv9, e_q, rho0DetJ0w, gamma, tables["Winv"],
        h0_e=h0, h1order=h1order, cfl=cfl, use_viscosity=use_viscosity,
        use_vorticity=use_viscosity and use_vorticity)
    return sJit9, torch.min(dtq)
