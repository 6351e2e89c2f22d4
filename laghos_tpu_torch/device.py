"""Device selection and numeric settings for a run."""

from __future__ import annotations

import torch


def setup(device: str = "cuda") -> torch.device:
    """Return the torch device for `device` ("cpu" or "cuda"), with full
    float32 precision pinned for matmuls and cuDNN (no TF32), as the JAX
    package pins full-f32 matmuls (laghos_tpu/__init__.py).

    Raises if CUDA is asked for and not available: a run never falls back
    to the CPU."""
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"device must be cpu or cuda, got {device!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA device requested but "
                               "torch.cuda.is_available() is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
