"""Whole-lattice banded-operator contractions on raster Cartesian meshes.

The torch counterpart of `laghos_tpu.ops.lattice`; its Ozaki branches
(`oz`, an `ops/lattice_oz` build) run the same chains as f64-accurate int8
products.  On a raster-renumbered Cartesian mesh the H1 L-vector is a
dense (Lz, Ly, Lx) lattice (x fastest), L = n*p + 1 per axis.  The per-axis
dof->qpoint evaluation is one banded matrix T (L, n*nq) with
T[e*p + a, e*nq + q] = B1d[q, a]: the element overlap lands in distinct
columns, and T^T performs the assembly across elements.  A PA mass apply is

    y = Tz' Ty' Tx' ( D  *  Tx Ty Tz u )        (6 contractions + 1 mul)

with no gather, no scatter and no atomics.  The q-update gradients and the
force pair run the same way on the dense q-lattice (Qz, Qy, Qx).  On the
card the mass apply runs as the CUDA kernel `csrc/lattice_mass.cu`
(`mass_apply_lattice`; its plain twin, the chain above, serves CPU
tensors), and the pointwise physics as the lattice-layout CUDA kernel
(`ops/qphys.physics_3d_lattice`); the gradient and force contractions stay
`torch.tensordot`/`einsum`, as the JAX package leaves them to XLA.
Reference counterpart: the
MassPAOperator and ForcePAOperator apply chains
(laghos_assembly.cpp:145-514).

Axis conventions: lattice axes are (z, y, x) while `StructMaps.dims` is
(x, y, z); J[a*3+b] = d x_a / d xi_b with b = 0 the x direction (lattice
axis 2); stress data sJ[gd*3+vd] as in ops/qphys.
"""

from __future__ import annotations

import dataclasses
import math
import weakref

import numpy as np
import torch

from . import kernels, qphys, tensor


def banded_eval_table(B1d: np.ndarray, n: int) -> np.ndarray:
    """(L, Q) banded dof->qpoint table for n elements along one axis.

    B1d: (nq, p+1) 1D basis values at the element quadrature points.
    """
    nq, nd1 = B1d.shape
    p = nd1 - 1
    L, Q = n * p + 1, n * nq
    T = np.zeros((L, Q))
    for e in range(n):
        for a in range(nd1):
            T[e * p + a, e * nq:(e + 1) * nq] = B1d[:, a]
    return T


def banded_grad_table(G1d: np.ndarray, n: int) -> np.ndarray:
    """(L, Q) banded dof->qpoint derivative table (the layout of
    banded_eval_table with the 1D gradient basis)."""
    return banded_eval_table(G1d, n)


def qlattice_weights(w_eq: np.ndarray, dims: tuple, nq1: int) -> np.ndarray:
    """Per-element q-data (NE, nq1**d) in raster element order and lex
    qpoint order -> the dense q-lattice (Qz, Qy, Qx) (or (Qy, Qx))."""
    d = len(dims)
    out = w_eq.reshape(tuple(reversed(dims)) + (nq1,) * d)
    # axes (e_z.., e_x, q_z.., q_x) -> interleave to (e_z, q_z, ..., e_x, q_x)
    perm = []
    for k in range(d):
        perm += [k, d + k]
    out = np.transpose(out, perm)
    return out.reshape(tuple(dims[d - 1 - k] * nq1 for k in range(d)))


def _contract(q, T, ax, side):
    """Contract axis `ax` of q with T; side 0 = forward (L->Q), side 1 =
    transpose (Q->L).  The new axis takes the place of the old one."""
    return torch.movedim(torch.tensordot(q, T, dims=([ax], [side])), -1, ax)


def mass_apply_lattice(uL, Ts, Dq, lat_dims):
    """PA mass apply on the raster lattice.

    uL: (C, ndof) raster-numbered L-vector; Ts: per-axis banded tables
    ordered (z, y, x); Dq: the dense q-lattice weights (rho0 detJ0 w);
    lat_dims: (Lz, Ly, Lx).  Returns (C, ndof).

    The operands are contiguous tensors of one dtype (f32 or f64) on one
    device, of shapes that fit (ValueError otherwise).  A CUDA tensor goes
    to the kernel `csrc/lattice_mass.cu` (counted in
    `mass_apply_lattice.launches`), which needs tables of the banded form
    of `banded_eval_table` (`lattice_table`); a CPU tensor to
    `mass_apply_lattice_plain`."""
    _check(uL, Ts, Dq, lat_dims)
    if uL.device.type == "cpu":
        return mass_apply_lattice_plain(uL, Ts, Dq, lat_dims)
    if uL.device.type != "cuda":
        raise NotImplementedError(f"no lattice mass kernel for {uL.device}")
    tab = lattice_table(Ts)
    C = uL.shape[0]
    y = torch.empty_like(uL)
    ye = torch.empty((C, math.prod(tab.elems), tab.nd1 ** len(lat_dims)),
                     dtype=uL.dtype, device=uL.device)
    kernels.launch_lattice_mass(uL, Dq, tab.B, tab.host, ye, y, C=C,
                                elems=tab.elems, nd1=tab.nd1, nq1=tab.nq1)
    mass_apply_lattice.launches += 1
    return y


mass_apply_lattice.launches = 0


def _check(uL, Ts, Dq, lat_dims):
    """Raises ValueError on operands of the lattice mass apply that are not
    contiguous tensors of one dtype (f32 or f64) on one device, or whose
    shapes do not fit: uL (C, prod lat_dims), Ts[k] (lat_dims[k],
    Dq.shape[k]) for each of the 1-3 axes."""
    d = len(lat_dims)
    if d not in (1, 2, 3) or len(Ts) != d:
        raise ValueError(f"lattice mass apply: {len(Ts)} tables for "
                         f"lat_dims {tuple(lat_dims)} (1-3 axes)")
    ts = (uL, Dq, *Ts)
    if (uL.dtype not in (torch.float32, torch.float64)
            or any(t.dtype != uL.dtype for t in ts)):
        raise ValueError(f"lattice mass apply takes float32 or float64 "
                         f"operands of one dtype, got u {uL.dtype}, Dq "
                         f"{Dq.dtype}, Ts {[T.dtype for T in Ts]}")
    if any(t.device != uL.device for t in ts):
        raise ValueError(f"lattice mass apply devices differ: u "
                         f"{uL.device}, Dq {Dq.device}, Ts "
                         f"{[T.device for T in Ts]}")
    if (uL.dim() != 2 or uL.shape[1] != math.prod(lat_dims)
            or Dq.dim() != d
            or any(tuple(T.shape) != (lat_dims[k], Dq.shape[k])
                   for k, T in enumerate(Ts))):
        raise ValueError(f"lattice mass apply shapes do not fit: u "
                         f"{tuple(uL.shape)}, Ts "
                         f"{[tuple(T.shape) for T in Ts]}, Dq "
                         f"{tuple(Dq.shape)}, lat_dims {tuple(lat_dims)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("lattice mass apply takes contiguous operands")


def mass_apply_lattice_plain(uL, Ts, Dq, lat_dims):
    """The plain torch version of `mass_apply_lattice` (its kernel's twin):
    the chain of 2 d banded tensordots around the D product."""
    C = uL.shape[0]
    d = len(lat_dims)
    q = uL.reshape((C,) + tuple(lat_dims))
    for k in range(d):
        q = _contract(q, Ts[k], 1 + k, 0)
    q = q * Dq[None]
    for k in range(d):
        q = _contract(q, Ts[k], 1 + k, 1)
    return q.reshape(C, -1)


def banded_factors(tables):
    """(elements an axis, B (nq1, nd1)) with tables[k] ==
    banded_eval_table(B, elements[k]) for every axis k, one B for all, at
    the smallest element order that fits; ValueError if none does.

    tables: NumPy (L_k, Q_k) arrays.  The order is not in the tables'
    shapes (L = n p + 1 and Q = n nq1 fit several (n, p, nq1)), so each
    order p whose sizes divide is tried on the values; a coarser fit (two
    elements taken as one of twice the order) gives the same operator."""
    L0 = tables[0].shape[0]
    for p in range(1, L0):
        if any((T.shape[0] - 1) % p for T in tables):
            continue
        ns = tuple((T.shape[0] - 1) // p for T in tables)
        nq = {T.shape[1] // n for T, n in zip(tables, ns)
              if T.shape[1] % n == 0}
        if len(nq) != 1 or any(T.shape[1] % n for T, n in zip(tables, ns)):
            continue
        nq1 = nq.pop()
        B = tables[0][:p + 1, :nq1].T
        if all(np.array_equal(banded_eval_table(B, n), T)
               for T, n in zip(tables, ns)):
            return ns, np.ascontiguousarray(B)
    raise ValueError(f"the lattice mass kernel takes banded tables "
                     f"(banded_eval_table); shapes "
                     f"{[T.shape for T in tables]} have no such form")


@dataclasses.dataclass(frozen=True)
class LatticeTable:
    """What the kernel needs of a set of banded tables: the elements an
    axis (z, y, x), the 1D table B (nq1, nd1) on the tables' device and on
    the host (the compiled instances take it as a kernel parameter)."""

    elems: tuple
    nd1: int
    nq1: int
    B: torch.Tensor
    host: torch.Tensor


# ids of the tables -> (weak references, versions, LatticeTable)
_TABLES = {}


def _keep(Ts, elems, B):
    """Records and returns the LatticeTable of Ts, the banded tables of the
    1D table B (NumPy (nq1, nd1)) on `elems` elements an axis (z, y, x),
    kept while these tensor objects live at their current versions."""
    Bh = torch.from_numpy(np.ascontiguousarray(B)).to(Ts[0].dtype)
    tab = LatticeTable(tuple(elems), B.shape[1], B.shape[0],
                       Bh.to(Ts[0].device), Bh)
    if not any(T.is_inference() for T in Ts):
        key = tuple(id(T) for T in Ts)
        refs = tuple(weakref.ref(T, lambda _, k=key: _TABLES.pop(k, None))
                     for T in Ts)
        _TABLES[key] = (refs, tuple(T._version for T in Ts), tab)
    return tab


def lattice_table(Ts):
    """The LatticeTable of the banded tables Ts: the one recorded where
    they were made (`build_lattice_ops`, `cast_tables`), else found from
    their values (`banded_factors` on `kernels.host_table` copies: one
    sync a table) and recorded."""
    hit = _TABLES.get(tuple(id(T) for T in Ts))
    if (hit is not None and all(r() is T for r, T in zip(hit[0], Ts))
            and hit[1] == tuple(T._version for T in Ts)):
        return hit[2]
    host = [kernels.host_table(T) for T in Ts]
    elems, B = banded_factors([h.numpy() for h in host])
    return _keep(Ts, elems, B)


def cast_tables(Ts, dtype):
    """Copies of the banded tables Ts in `dtype`, with their LatticeTable
    recorded from that of Ts."""
    tab = lattice_table(Ts)
    out = tuple(T.to(dtype) for T in Ts)
    _keep(out, tab.elems, tab.host.numpy())
    return out


def grad9_lattice(u3, TB, TG):
    """All nine first derivatives of a vector lattice field.

    u3: (3, Lz, Ly, Lx); TB/TG: per-axis (z, y, x) banded value/gradient
    tables.  Returns the list J[a*3+b] = d u_a / d xi_b on the q-lattice,
    sharing the partial contractions (8 per component)."""
    out = []
    for a in range(3):
        u = u3[a]
        tzB = torch.tensordot(u, TB[0], dims=([0], [0]))   # (y, x, Qz)
        tzG = torch.tensordot(u, TG[0], dims=([0], [0]))
        tBB = torch.tensordot(tzB, TB[1], dims=([0], [0]))  # (x, Qz, Qy)
        tBG = torch.tensordot(tzB, TG[1], dims=([0], [0]))
        tGB = torch.tensordot(tzG, TB[1], dims=([0], [0]))
        d_x = torch.tensordot(tBB, TG[2], dims=([0], [0]))  # (Qz, Qy, Qx)
        d_y = torch.tensordot(tBG, TB[2], dims=([0], [0]))
        d_z = torch.tensordot(tGB, TB[2], dims=([0], [0]))
        out += [d_x, d_y, d_z]
    return out


def force_one_lattice(sJ, TB, TG):
    """(F . 1) on the H1 lattice from q-lattice stress data.

    sJ: (9, Qz, Qy, Qx) stack, sJ[gd*3+vd].  Returns (3, Lz, Ly, Lx):
    y[vd] = sum_gd chain_gd^T sJ[gd*3+vd]."""
    ys = []
    for vd in range(3):
        acc = None
        for gd in range(3):
            # gradient table on the axis of gd (gd = 0 is x = lattice
            # axis 2)
            Tz = TG[0] if gd == 2 else TB[0]
            Ty = TG[1] if gd == 1 else TB[1]
            Tx = TG[2] if gd == 0 else TB[2]
            t = torch.tensordot(sJ[gd * 3 + vd], Tz, dims=([0], [1]))
            t = torch.tensordot(t, Ty, dims=([0], [1]))    # (Qx, Lz, Ly)
            t = torch.tensordot(t, Tx, dims=([0], [1]))    # (Lz, Ly, Lx)
            acc = t if acc is None else acc + t
        ys.append(acc)
    return torch.stack(ys, dim=0)


def grad4_lattice(u2, TB, TG):
    """All four first derivatives of a 2-vector lattice field.

    u2: (2, Ly, Lx); TB/TG: per-axis (y, x) tables.  Returns the list
    J[a*2+b] = d u_a / d xi_b with b = 0 the x direction."""
    out = []
    for a in range(2):
        tyB = torch.tensordot(u2[a], TB[0], dims=([0], [0]))  # (x, Qy)
        tyG = torch.tensordot(u2[a], TG[0], dims=([0], [0]))
        d_x = torch.tensordot(tyB, TG[1], dims=([0], [0]))    # (Qy, Qx)
        d_y = torch.tensordot(tyG, TB[1], dims=([0], [0]))
        out += [d_x, d_y]
    return out


def force_one_lattice_2d(sJ, TB, TG):
    """(F . 1) on the H1 lattice from 2D stress data sJ (4, Qy, Qx),
    sJ[gd*2+vd]; returns (2, Ly, Lx)."""
    ys = []
    for vd in range(2):
        acc = None
        for gd in range(2):
            Ty = TG[0] if gd == 1 else TB[0]
            Tx = TG[1] if gd == 0 else TB[1]
            t = torch.tensordot(sJ[gd * 2 + vd], Ty, dims=([0], [1]))
            t = torch.tensordot(t, Tx, dims=([0], [1]))    # (Ly, Lx)
            acc = t if acc is None else acc + t
        ys.append(acc)
    return torch.stack(ys, dim=0)


def qlattice_to_eq_2d(q, dims, nq1):
    """Dense q-lattice (Qy, Qx) -> per-element (NE, NQ)."""
    ny, nx = dims[1], dims[0]
    t = q.reshape(ny, nq1, nx, nq1).permute(0, 2, 1, 3)
    return t.reshape(ny * nx, nq1 ** 2)


def eq_to_qlattice_2d(x, dims, nq1):
    """Per-element (NE, NQ) -> dense q-lattice (Qy, Qx)."""
    ny, nx = dims[1], dims[0]
    t = x.reshape(ny, nx, nq1, nq1).permute(0, 2, 1, 3)
    return t.reshape(ny * nq1, nx * nq1)


def qlattice_to_eq(q, dims, nq1):
    """Dense q-lattice (Qz, Qy, Qx) -> per-element (NE, NQ) (raster
    element order, lex qpoint order)."""
    nz, ny, nx = dims[2], dims[1], dims[0]
    t = q.reshape(nz, nq1, ny, nq1, nx, nq1).permute(0, 2, 4, 1, 3, 5)
    return t.reshape(nz * ny * nx, nq1 ** 3)


def eq_to_qlattice(x, dims, nq1):
    """Per-element (NE, NQ) -> dense q-lattice (Qz, Qy, Qx)."""
    nz, ny, nx = dims[2], dims[1], dims[0]
    t = x.reshape(nz, ny, nx, nq1, nq1, nq1).permute(0, 3, 1, 4, 2, 5)
    return t.reshape(nz * nq1, ny * nq1, nx * nq1)


def energy_qlattice(e_b, edims, tables, d):
    """L2 energy at the q-points, rearranged onto the q-lattice (the L2
    space is discontinuous, so it stays per element until here)."""
    nq1 = tables["H1B"].shape[0]
    l1d = tables["L2B"].shape[1]
    NE = e_b.shape[0]
    et = e_b.reshape((NE,) + (l1d,) * d)
    e_q = tensor.eval_values(et, tables["L2B"], d).reshape(NE, nq1 ** d)
    if d == 3:
        return eq_to_qlattice(e_q, edims, nq1).contiguous()
    return eq_to_qlattice_2d(e_q, edims, nq1).contiguous()


def qupdate2d_lattice(xL, vL, e_b, lat, lat_dims, edims, tables, *,
                      h1order, cfl, use_viscosity, use_vorticity):
    """Whole-lattice 2D q-update: banded gradients feeding the 2D
    pointwise physics (ops/qphys.physics_2d).

    Returns (sJit (4, Qy, Qx), dt_est)."""
    TB, TG = lat["Ts"], lat["Tg"]
    J4 = grad4_lattice(xL.reshape((2,) + tuple(lat_dims)), TB, TG)
    e_q = energy_qlattice(e_b, edims, tables, 2)
    dV4 = (grad4_lattice(vL.reshape((2,) + tuple(lat_dims)), TB, TG)
           if use_viscosity else None)
    sJit4, dtq, _ = qphys.physics_2d(
        J4, dV4, lat["J0i4"].unbind(0), e_q, lat["rw"], lat["gam"],
        lat["winv"], h0_e=lat["h0"], h1order=h1order, cfl=cfl,
        use_viscosity=use_viscosity, use_vorticity=use_vorticity)
    return torch.stack(sJit4), torch.min(dtq)


def force_transpose_lattice_2d(vL, sJ, lat, lat_dims, edims, tables):
    """F^T . v from 2D q-lattice stress data: e_rhs (NE, ld)."""
    nq1 = tables["H1B"].shape[0]
    dV4 = grad4_lattice(vL.reshape((2,) + tuple(lat_dims)), lat["Ts"],
                        lat["Tg"])
    eq = None
    for gd in range(2):
        for vd in range(2):
            term = dV4[vd * 2 + gd] * sJ[gd * 2 + vd]
            eq = term if eq is None else eq + term
    eq = qlattice_to_eq_2d(eq, edims, nq1)
    et = eq.reshape((eq.shape[0],) + (nq1,) * 2)
    out = tensor.eval_transpose(et, tables["L2B"].T, 2)
    return out.reshape(eq.shape[0], -1)


def qupdate3d_lattice(xL, vL, e_b, lat, lat_dims, edims, tables, *,
                      h1order, cfl, use_viscosity, use_vorticity, oz=None):
    """Whole-lattice 3D q-update: banded gradients feeding the pointwise
    physics on the q-lattice (ops/qphys.physics_3d_lattice, the CUDA
    kernel on the card).

    xL/vL: (3, ndof) raster L-vectors; e_b: (NE, ld) L2 dofs; lat: the
    lattice tables and q-lattice constants of `build_lattice_ops`.  With
    `oz` (an ops/lattice_oz build) the gradients and the L2 evaluation run
    as Ozaki products (`grad18_lattice_oz`, or `grad9_lattice_oz` when
    inviscid, then `l2_eval_oz`).  Returns (sJit (9, Qz, Qy, Qx), dt_est)."""
    TB, TG = lat["Ts"], lat["Tg"]
    x3 = xL.reshape((3,) + tuple(lat_dims))
    v3 = vL.reshape((3,) + tuple(lat_dims))
    if oz is not None:
        from . import lattice_oz as lzo

        nq1 = tables["H1B"].shape[0]
        if use_viscosity:
            J9, dV9 = lzo.grad18_lattice_oz(x3, v3, oz)
        else:
            J9, dV9 = lzo.grad9_lattice_oz(x3, oz), None
        e_q = eq_to_qlattice(lzo.l2_eval_oz(e_b, oz), edims,
                             nq1).contiguous()
    else:
        J9 = torch.stack(grad9_lattice(x3, TB, TG))
        e_q = energy_qlattice(e_b, edims, tables, 3)
        dV9 = (torch.stack(grad9_lattice(v3, TB, TG))
               if use_viscosity else None)
    sJit9, dtq = qphys.physics_3d_lattice(
        J9, dV9, lat["J0i9"], e_q, lat["rw"], lat["gam"], lat["winv"],
        h0=lat["h0"], h1order=h1order, cfl=cfl,
        use_viscosity=use_viscosity,
        use_vorticity=use_viscosity and use_vorticity)
    return sJit9, torch.min(dtq)


def force_transpose_lattice(vL, sJ, lat, lat_dims, edims, tables, oz=None,
                            oz_slices=None):
    """F^T . v from q-lattice stress data sJ (9, Qz, Qy, Qx): e_rhs
    (NE, ld).  With `oz` the gradients and the L2 transpose run as Ozaki
    products at `oz_slices` dynamic slices (None: the build's count)."""
    nq1 = tables["H1B"].shape[0]
    v3 = vL.reshape((3,) + tuple(lat_dims))
    if oz is not None:
        from . import lattice_oz as lzo

        dV9 = lzo.grad9_lattice_oz(v3, oz, n_slices=oz_slices)
    else:
        dV9 = grad9_lattice(v3, lat["Ts"], lat["Tg"])
    eq = None
    for gd in range(3):
        for vd in range(3):
            term = dV9[vd * 3 + gd] * sJ[gd * 3 + vd]
            eq = term if eq is None else eq + term
    eq = qlattice_to_eq(eq, edims, nq1)
    if oz is not None:
        return lzo.l2_transpose_oz(eq, oz, n_slices=oz_slices)
    et = eq.reshape((eq.shape[0],) + (nq1,) * 3)
    out = tensor.eval_transpose(et, tables["L2B"].T, 3)
    return out.reshape(eq.shape[0], -1)


def kron_mass_factors(Dq: np.ndarray, Ts_np: tuple) -> list:
    """Per-axis 1D mass factors from the best rank-1 log-separable fit of
    the q-lattice weights.

    M = (Tz' (.) Tz)(Ty' ...)(Tx' ...) couples the axes only through Dq;
    if Dq[i,j,k] = wz[i] wy[j] wx[k] then M is exactly Az (x) Ay (x) Ax
    with A_k = T_k diag(w_k) T_k'.  The fit is the per-axis mean of log Dq
    (Dq > 0 always): exact whenever rho0 detJ0 separates per axis, as for
    any constant-rho0 problem on an affine raster mesh (Sedov).  The
    mass matrix is constant in time (laghos_solver.cpp:178), so this runs
    once.  Returns [(A_k, relerr)] per lattice axis (z, y, x)."""
    d = Dq.ndim
    L = np.log(Dq)
    m = float(L.mean())
    ws = []
    for k in range(d):
        other = tuple(a for a in range(d) if a != k)
        ws.append(np.exp(L.mean(axis=other) - (d - 1) / d * m))
    approx = ws[0]
    for k in range(1, d):
        approx = np.multiply.outer(approx, ws[k])
    relerr = float(np.max(np.abs(Dq - approx) / Dq))
    return [(T @ np.diag(w) @ T.T, relerr) for T, w in zip(Ts_np, ws)]


def build_kron_precond(ess_mask: np.ndarray, lat_dims: tuple,
                       Dq: np.ndarray, Ts_np: tuple):
    """Per-component per-axis inverse mass factors for the Kronecker
    velocity-mass preconditioner.

    Essential BCs keep the Kronecker structure when each component's free
    set is a Cartesian product of per-axis index sets (v.n = 0 on box
    boundaries).  The constrained inverse is then the Kronecker product of
    restricted dense inverses, embedded with zero rows and columns on
    constrained dofs (SPD on the free subspace).  Returns (mats, relerr)
    with mats[k] of shape (C, L_k, L_k), or None if any component's free
    set is not an axis product (then "auto" runs Jacobi)."""
    C = ess_mask.shape[0]
    d = len(lat_dims)
    factors = kron_mass_factors(Dq, Ts_np)
    relerr = factors[0][1]
    mats = [np.zeros((C, Lk, Lk)) for Lk in lat_dims]
    cache = {}
    for c in range(C):
        free = ~ess_mask[c].reshape(lat_dims)
        fs = []
        for k in range(d):
            other = tuple(a for a in range(d) if a != k)
            fs.append(free.any(axis=other))
        prod = fs[0]
        for k in range(1, d):
            prod = np.multiply.outer(prod, fs[k])
        if not np.array_equal(free, prod):
            return None
        for k in range(d):
            key = (k, fs[k].tobytes())
            if key not in cache:
                A, _ = factors[k]
                idx = np.where(fs[k])[0]
                Minv = np.zeros_like(A)
                Minv[np.ix_(idx, idx)] = np.linalg.inv(A[np.ix_(idx, idx)])
                cache[key] = Minv
            mats[k][c] = cache[key]
    return mats, relerr


def kron_precond_apply(r, mats, lat_dims):
    """Apply the per-component Kronecker inverse: one small dense
    contraction per lattice axis."""
    C = r.shape[0]
    u = r.reshape((C,) + tuple(lat_dims))
    for k, P in enumerate(mats):
        u = torch.movedim(u, 1 + k, -1)
        u = torch.einsum("c...j,cij->c...i", u, P)
        u = torch.movedim(u, -1, 1 + k)
    return u.reshape(C, -1)


def build_lattice_ops(h, dev):
    """Banded tables and q-lattice constants for a `Hydro` on a raster
    mesh, as tensors made by `dev` (the run's dtype and device); None if
    the mesh is not raster.

    The q-lattice constants come from the host arrays of `h` in f64 (the
    t=0 data, the element gamma, 1/W, Jac0inv), rearranged per axis, then
    cast once, as `laghos_tpu.ops.lattice.build_lattice_ops` does."""
    sm = h._sm
    if sm is None or not sm.identity_perm:
        return None
    dims = sm.dims                  # (n_x, n_y, n_z)
    d = len(dims)
    n_zyx = tuple(reversed(dims))   # lattice axes are (z, y, x)
    nq1, NE, NQ = h.nq1, h.NE, h.NQ
    B, G, W = (h._tables_cpu[k].double().numpy() for k in ("H1B", "H1G",
                                                            "W"))
    Ts_np = tuple(banded_eval_table(B, n) for n in n_zyx)
    Dq = qlattice_weights(h.massD.cpu().double().numpy(), dims, nq1)
    lat_dims = tuple(n * h.opt.order_v + 1 for n in n_zyx)

    def ql(a):
        return dev(torch.from_numpy(np.ascontiguousarray(
            qlattice_weights(np.asarray(a, dtype=np.float64), dims, nq1))))

    out = {
        "Ts": tuple(dev(torch.from_numpy(T)) for T in Ts_np),
        "Tg": tuple(dev(torch.from_numpy(banded_grad_table(G, n)))
                    for n in n_zyx),
        "Dq": dev(torch.from_numpy(Dq)),
        "lat_dims": lat_dims,
        "rw": ql(h.rho0DetJ0w),
        "gam": ql(np.broadcast_to(
            h.gamma_t.cpu().double().numpy()[:, None], (NE, NQ))),
        "winv": ql(np.broadcast_to(1.0 / W[None, :], (NE, NQ))),
        "h0": float(h.h0),
        f"J0i{d * d}": torch.stack([
            ql(h.Jac0inv[..., a, b]) for a in range(d) for b in range(d)]),
    }
    _keep(out["Ts"], n_zyx, B)
    if h.opt.precond in ("auto", "kron"):
        kb = build_kron_precond(np.asarray(h.ess_mask, bool), lat_dims, Dq,
                                Ts_np)
        if kb is not None:
            mats, relerr = kb
            out["kron"] = tuple(dev(torch.from_numpy(Mk)) for Mk in mats)
            out["kron_relerr"] = relerr
    return out
