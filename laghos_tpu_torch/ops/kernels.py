"""Build and bind the hand-written CUDA kernels in `laghos_tpu_torch/csrc/`.

The sources are compiled with nvcc for Hopper (`sm_90a`) into a shared
library with a plain C interface, loaded with ctypes.  The build happens at
first use, on the machine with the card, into `laghos_tpu_torch/build/`
(listed in .gitignore), keyed on a hash of the sources and flags, so a
fresh checkout builds once and later processes reuse the library.

Nothing is built or loaded while the package is imported: the CPU tests
import every module, and a kernel is built only when a wrapper is first
handed a CUDA tensor (or `chip_smoke.py` asks for the build).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

# No fast math: IEEE div/sqrt and no flush-to-zero (nvcc's defaults).
# -Xptxas -v writes registers, shared memory and spills to the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path          # the shared library
    log: str            # nvcc's output (ptxas register/spill report)
    seconds: float      # compile time; 0.0 when the library was cached


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on the machine with the card")


def build() -> Build:
    """Compile csrc/*.cu into build/libqphys_<hash>.so (once per source
    version) and return where it is."""
    sources = sorted(SRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    key = digest.hexdigest()[:16]
    so = BUILD_DIR / f"libqphys_{key}.so"
    log = BUILD_DIR / f"libqphys_{key}.log"
    if so.exists():
        return Build(so, log.read_text() if log.exists() else "", 0.0)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libqphys_{key}.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{out}")
    log.write_text(out)
    os.replace(tmp, so)       # atomic: concurrent builders agree
    return Build(so, out, seconds)


@functools.lru_cache(maxsize=None)
def library():
    """(ctypes library, Build), built and loaded once per process."""
    b = build()
    lib = ctypes.CDLL(str(b.path))
    p = ctypes.c_void_p
    lib.qphys_launch.argtypes = [
        ctypes.c_int, ctypes.c_int, p, p, p, p, p, p, p, p, p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_int, ctypes.c_int, p]
    lib.qphys_launch.restype = ctypes.c_int
    lib.qphys_error_string.argtypes = [ctypes.c_int]
    lib.qphys_error_string.restype = ctypes.c_char_p
    return lib, b


def launch_qphys(J9, dV9, J0i9, e_q, rw, gamma, winv, sJit, dtq, *, h0,
                 h1order, cfl, use_viscosity, use_vorticity):
    """Launch csrc/qphys.cu on PyTorch's current stream.  Arguments are
    CUDA tensors already checked by the caller (ops/qphys.physics_3d);
    raises on a refused launch."""
    import torch

    lib, _ = library()
    N = e_q.numel()
    NQ = winv.numel()
    code = {torch.float32: 0, torch.float64: 1}[J9.dtype]
    stream = torch.cuda.current_stream(J9.device).cuda_stream
    err = lib.qphys_launch(
        code, J9.device.index, J9.data_ptr(), dV9.data_ptr(),
        J0i9.data_ptr(), e_q.data_ptr(), rw.data_ptr(), gamma.data_ptr(),
        winv.data_ptr(), sJit.data_ptr(), dtq.data_ptr(), N, NQ,
        float(h0), float(h1order), float(cfl), int(bool(use_viscosity)),
        int(bool(use_vorticity)), stream)
    if err != 0:
        msg = lib.qphys_error_string(err).decode()
        raise RuntimeError(f"qphys kernel launch failed: {msg} ({err})")
