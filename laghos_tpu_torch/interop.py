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
