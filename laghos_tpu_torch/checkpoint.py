"""Checkpoint / resume: NPZ snapshots of (S, t, dt, step).

The counterpart of `laghos_tpu.checkpoint`, with the same NPZ keys (x, v,
e, t, dt, step), so a snapshot written by either package restores in the
other.  `step` is the last completed step; a resumed run continues at
step + 1 and repeats the uninterrupted run bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import setup


def save(path: str, S: dict, t: float, dt: float, step: int):
    np.savez(path, **{k: S[k].detach().cpu().numpy() for k in ("x", "v",
                                                               "e")},
             t=np.float64(t), dt=np.float64(dt), step=np.int64(step))


def load(path: str, device="cuda", dtype=torch.float64):
    """(S, t, dt, step) from the snapshot at `path`, the state as tensors
    of `dtype` on `device` ("cuda", the default, or "cpu"; resolved by
    device.setup: without a card "cuda" raises)."""
    device = setup(device)
    z = np.load(path)
    S = {k: torch.tensor(z[k], dtype=dtype, device=device)
         for k in ("x", "v", "e")}
    return S, float(z["t"]), float(z["dt"]), int(z["step"])
