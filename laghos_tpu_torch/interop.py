"""Carry a run's data across to and from NumPy.

The system has no trained weights: its parameters are the mesh-derived
arrays and the state.  These helpers move them across in the JAX package's
layout, so the same state can feed both packages and their static arrays
can be compared.
"""

from __future__ import annotations

import numpy as np
import torch


def state_from_numpy(S: dict, device="cpu", dtype=torch.float64) -> dict:
    """{"x": (dim, ndof), "v": (dim, ndof), "e": (NE, ld)} arrays ->
    contiguous tensors on `device`."""
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
