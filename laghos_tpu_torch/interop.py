"""Carry a run's data across to and from NumPy.

The system has no trained weights: its parameters are the mesh-derived
arrays and the state.  These helpers move them across in the JAX package's
layout, so the same state can feed both packages and their static arrays
can be compared.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import setup


def state_from_numpy(S: dict, device="cuda", dtype=torch.float64) -> dict:
    """{"x": (dim, ndof), "v": (dim, ndof), "e": (NE, ld)} arrays (any
    leading axes) -> contiguous tensors on `device` ("cuda", the default,
    or "cpu"; resolved by device.setup: without a card "cuda" raises)."""
    device = setup(device)
    return {k: torch.tensor(np.asarray(S[k]), dtype=dtype, device=device)
            for k in ("x", "v", "e")}


def state_to_numpy(S: dict) -> dict:
    return {k: S[k].detach().cpu().numpy() for k in ("x", "v", "e")}


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def hydro_arrays(h) -> dict:
    """The static arrays of a port `Hydro` as NumPy, under the attribute
    names of `laghos_tpu.hydro.Hydro`: gather, ess_mask, massD,
    rho0DetJ0w, Jac0inv (NE, NQ, d, d), h1_dinv, tables (H1B, H1G, L2B,
    W) and S0."""
    return {
        "gather": np.asarray(h.h1.gather),
        "ess_mask": np.asarray(h.ess_mask),
        "massD": _np(h.massD),
        "rho0DetJ0w": np.asarray(h.rho0DetJ0w),
        "Jac0inv": np.asarray(h.Jac0inv),
        "h1_dinv": _np(h.h1_dinv),
        "tables": {k: _np(h.tables[k]) for k in ("H1B", "H1G", "L2B", "W")},
        "S0": state_to_numpy(h.S0),
    }


def lattice_arrays(h) -> dict:
    """The whole-lattice data of a port `Hydro` as NumPy, under the keys
    of `laghos_tpu.hydro.Hydro._lat`: the banded tables Ts and Tg (tuples
    over the lattice axes z, y, x), Dq, rw, gam, winv, J0i9 (3D) or J0i4
    (2D) stacked on a leading axis, and kron (per-axis factors) where the
    preconditioner was built; plus "dims" (`_sm.dims`, elements per axis
    x-first) and "lat_dims" (`_lat_dims`).  None off the lattice path."""
    if h._lat is None:
        return None
    out = {k: tuple(_np(t) for t in v) if isinstance(v, tuple) else _np(v)
           for k, v in h._lat.items() if k not in ("h0", "kron_relerr")}
    out["dims"] = tuple(h._sm.dims)
    out["lat_dims"] = tuple(h._lat_dims)
    return out


def _split_arrays(st) -> dict:
    """One `ops/omm.StaticSplit` as NumPy under the JAX package's field
    names."""
    return {"slices": tuple(_np(t) for t in st.slices),
            "levels": tuple(st.levels), "scale": _np(st.scale),
            "e": tuple(st.e), "n_slices": st.n_slices,
            "stacks": tuple(_np(t) for t in st.stacks)}


def ozaki_arrays(h) -> dict:
    """The static Ozaki splits of a port `Hydro` as NumPy, under the keys
    of `laghos_tpu.hydro.Hydro`: "oz" (h.oz: h1, l2, force, forceT, qup,
    each a pair of splits) and "lat_oz" (h._lat_oz: fwdB, bwdB, fwdG, bwdG
    per lattice axis, l2fwd, l2bwd; None off the lattice path).  None
    outside Ozaki mode."""
    if h.oz is None:
        return None
    lat = None
    if h._lat_oz is not None:
        lat = {k: tuple(_split_arrays(s) for s in v) if isinstance(v, tuple)
               else _split_arrays(v) for k, v in h._lat_oz.items()}
    return {"oz": {k: tuple(_split_arrays(s) for s in v)
                   for k, v in h.oz.items()},
            "lat_oz": lat}


def simplex_state_from_numpy(S: dict, *, device,
                             dtype=torch.float64) -> dict:
    """A `SimplexHydro` state {"x": (dim, ndof), "v": (dim, ndof),
    "e": (NE, ld)} (a `laghos_tpu.simplex_hydro.SimplexHydro` state) ->
    tensors on `device`."""
    out = state_from_numpy(S, device=device, dtype=dtype)
    if (out["x"].dim() != 2 or out["x"].shape[0] not in (2, 3)
            or out["v"].shape != out["x"].shape or out["e"].dim() != 2):
        raise ValueError("not a simplex state: x, v (dim, ndof), e (NE, ld)")
    return out


def batch_state_from_numpy(Sb: dict, *, device, dtype=torch.float64) -> dict:
    """A member-batched state (every array with a leading B axis, as
    `batch.blast_states` and `laghos_tpu.batch.blast_states` make) ->
    tensors on `device`."""
    out = state_from_numpy(Sb, device=device, dtype=dtype)
    if len({out[k].shape[0] for k in out}) != 1 or out["x"].dim() != 3:
        raise ValueError("not a batched state: x, v (B, dim, ndof), "
                         "e (B, NE, ld)")
    return out


def sweep_to_numpy(out: dict) -> dict:
    """A `batch.sweep` result (S and the per-member t, dt, steps, crashed,
    h1_iters, l2_iters, each with a leading B axis) as NumPy, the layout
    of `laghos_tpu.batch.sweep`'s."""
    res = {k: _np(v) for k, v in out.items() if k != "S"}
    res["S"] = state_to_numpy(out["S"])
    return res


def simplex_arrays(h) -> dict:
    """The static arrays of a `SimplexHydro` as NumPy, under the attribute
    names of `laghos_tpu.simplex_hydro.SimplexHydro`: B, G, Bl, W, gather,
    massD, h1_dinv, Me_inv, rw, Jac0inv, h0 and S0."""
    return {"B": _np(h.B), "G": _np(h.G), "Bl": _np(h.Bl), "W": _np(h.W),
            "gather": np.asarray(h.gather_np), "massD": _np(h.massD),
            "h1_dinv": _np(h.h1_dinv), "Me_inv": _np(h.Me_inv),
            "rw": _np(h.rw), "Jac0inv": _np(h.Jac0inv), "h0": float(h.h0),
            "S0": state_to_numpy(h.S0)}
