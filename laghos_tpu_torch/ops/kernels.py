"""Build and bind the hand-written CUDA kernels in `laghos_tpu_torch/csrc/`.

The sources are compiled with nvcc for Hopper (`sm_90a`), one nvcc per
source, all started together, then linked into one shared library with a
plain C interface, loaded with ctypes.  The build happens at first use, on
the machine with the card, into `laghos_tpu_torch/build/` (listed in
.gitignore), keyed on a hash of the sources and flags, so a fresh checkout
builds once and later processes reuse the library.

Kernels: `csrc/qphys.cu` (the q-point physics, `launch_qphys`),
`csrc/split.cu` (the Ozaki split, `launch_split`), `csrc/mass.cu` (the
element PA mass apply, `launch_mass`), `csrc/lattice_mass.cu` (the
lattice H1 PA mass apply, `launch_lattice_mass`; the last two share the
device code of `csrc/mass_core.cuh`) and `csrc/cg.cu` (the CG iteration's
vector algebra, `CGLaunch`).

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
import re
import shutil
import subprocess
import threading
import time
import weakref
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

# No fast math: IEEE div/sqrt and no flush to zero (nvcc's defaults).
# -Xptxas -v writes registers, shared memory and spills to the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path          # the shared library
    log: str            # nvcc's output (ptxas register/spill report)
    seconds: float      # compile + link time; 0.0 when the library was cached


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on the machine with the card")


def _run_all(cmds):
    """Run the commands in parallel; (joined output, first failure)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs, failed = [], None
    for cmd, proc in zip(cmds, procs):
        outs.append(proc.communicate()[0])
        if proc.returncode != 0 and failed is None:
            failed = (proc.returncode, " ".join(cmd), outs[-1])
    return "".join(outs), failed


_BUILD_LOCK = threading.Lock()


def build() -> Build:
    """Compile every csrc/*.cu (one nvcc each, in parallel) and link them
    into build/liblaghos_<hash>.so, once per source version; return where
    it is.  Threads of one process build once (a second caller waits for
    the first)."""
    with _BUILD_LOCK:
        return _build()


def _build() -> Build:
    sources = sorted(SRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(sources + list(SRC_DIR.glob("*.cuh"))):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    key = digest.hexdigest()[:16]
    so = BUILD_DIR / f"liblaghos_{key}.so"
    log = BUILD_DIR / f"liblaghos_{key}.log"
    if so.exists():
        return Build(so, log.read_text() if log.exists() else "", 0.0)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{key}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}_{tag}.o" for src in sources]
    tmp = BUILD_DIR / f"liblaghos_{tag}.tmp.so"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    out, failed = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                            for src, o in zip(sources, objs)])
    if failed is None:
        link, failed = _run_all([[nvcc, "-shared", "-o", str(tmp),
                                  *map(str, objs)]])
        out += link
    seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink(missing_ok=True)
    if failed is not None:
        tmp.unlink(missing_ok=True)
        code, cmd, text = failed
        raise RuntimeError(f"nvcc failed ({code}):\n{cmd}\n{text}")
    log.write_text(out)
    os.replace(tmp, so)       # atomic: concurrent builders agree
    return Build(so, out, seconds)


def sass_instructions(path, opcodes=None, per_opcode=False) -> dict:
    """{mangled kernel name: static SASS instructions, NOPs left out} of the
    library at `path`, read with `cuobjdump -sass` from nvcc's toolkit;
    with `opcodes` (a set of opcode names such as {"DFMA", "DMUL"}) only
    the instructions whose opcode, up to its first ".", is one of them,
    and with `per_opcode` their counts {opcode: n} for each kernel."""
    return count_sass(_sass_text(str(path)), opcodes, per_opcode)


@functools.lru_cache(maxsize=4)
def _sass_text(path):
    """`cuobjdump -sass` of the library at `path`, once per process."""
    cuobjdump = str(Path(_nvcc()).with_name("cuobjdump"))
    return subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def count_sass(text, opcodes=None, per_opcode=False) -> dict:
    """The counts of `sass_instructions` from the text of `cuobjdump
    -sass`; instructions predicated on "@!PT" (never run) are left out."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            out[cur] = dict.fromkeys(opcodes, 0) if per_opcode else 0
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     line)
        # "@!PT" never runs (placeholders ptxas leaves beside cp.async)
        if (m is None or cur is None or m.group(2).startswith("NOP")
                or (m.group(1) or "").strip() == "@!PT"):
            continue
        op = m.group(2).split(".")[0]
        if per_opcode:
            if op in out[cur]:
                out[cur][op] += 1
        elif opcodes is None or op in opcodes:
            out[cur] += 1
    return out


# memory layouts of csrc/qphys.cu (its `Layout` enum)
ELEMENT, LATTICE, PACKED = 0, 1, 2


@functools.lru_cache(maxsize=None)
def library():
    """(ctypes library, Build), built and loaded once per process."""
    b = build()
    lib = ctypes.CDLL(str(b.path))
    p = ctypes.c_void_p
    lib.qphys_launch.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, p, p, p, p, p, p, p, p, p,
        p, ctypes.c_int64, ctypes.c_int64, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_int, ctypes.c_int, p]
    lib.qphys_launch.restype = ctypes.c_int
    lib.split_launch.argtypes = [
        ctypes.c_int, p, p, p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int, p]
    lib.split_launch.restype = ctypes.c_int
    lib.mass_launch.argtypes = [
        ctypes.c_int, ctypes.c_int, p, p, p, p, p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, p]
    lib.mass_launch.restype = ctypes.c_int
    lib.mass_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.mass_smem_bytes.restype = ctypes.c_int64
    lib.mass_smem_limit.argtypes = [ctypes.c_int]
    lib.mass_smem_limit.restype = ctypes.c_int64
    lib.mass_grid.argtypes = [ctypes.c_int] * 5
    lib.mass_grid.restype = ctypes.c_int64
    lib.lattice_mass_launch.argtypes = [
        ctypes.c_int, ctypes.c_int, p, p, p, p, p, p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, p]
    lib.lattice_mass_launch.restype = ctypes.c_int
    i64 = ctypes.c_int64
    lib.cg_partials.argtypes = [ctypes.c_int, ctypes.c_int, i64, i64]
    lib.cg_partials.restype = i64
    lib.cg_step_launch.argtypes = [
        ctypes.c_int, ctypes.c_int, i64, i64, i64, i64, p, p, p, p, p, i64, p,
        p, p, p, p, p, p, p, p]
    lib.cg_step_launch.restype = ctypes.c_int
    lib.cg_ess_dot_launch.argtypes = [
        ctypes.c_int, ctypes.c_int, i64, i64, i64, p, p, i64, p, p, p, p, p]
    lib.cg_ess_dot_launch.restype = ctypes.c_int
    lib.qphys_error_string.argtypes = [ctypes.c_int]
    lib.qphys_error_string.restype = ctypes.c_char_p
    return lib, b


def launch_qphys(layout, J, dV, J0i, e_q, rw, gamma, winv, sJit, dtq, visc,
                 *, NQ, h0, h1order, cfl, use_viscosity, use_vorticity):
    """Launch csrc/qphys.cu in `layout` (ELEMENT, LATTICE or PACKED) on
    PyTorch's current stream.  Arguments are CUDA tensors already checked
    by the caller (ops/qphys); `dV` may be None when use_viscosity is
    False, `visc` None when the caller does not want the viscosity
    coefficient; NQ is the q-points per element (unused by LATTICE).
    Raises on a refused launch."""
    import torch

    def ptr(t):
        return t.data_ptr() if t is not None else None

    lib, _ = library()
    code = {torch.float32: 0, torch.float64: 1}[J.dtype]
    stream = torch.cuda.current_stream(J.device).cuda_stream
    err = lib.qphys_launch(
        int(layout), code, J.device.index, J.data_ptr(), ptr(dV),
        J0i.data_ptr(), e_q.data_ptr(), rw.data_ptr(), gamma.data_ptr(),
        winv.data_ptr(), sJit.data_ptr(), dtq.data_ptr(), ptr(visc),
        e_q.numel(), int(NQ), float(h0), float(h1order), float(cfl),
        int(bool(use_viscosity)), int(bool(use_vorticity)), stream)
    if err != 0:
        msg = lib.qphys_error_string(err).decode()
        raise RuntimeError(f"qphys kernel launch failed: {msg} ({err})")


def launch_split(A, D, scale, *, R1, k, R2, kp, n_slices):
    """Launch csrc/split.cu on PyTorch's current stream: the Ozaki split of
    the contiguous f64 CUDA tensor A, viewed as (R1, k, R2), into the int8
    digits D (R1 * R2, n_slices * kp) and the f64 scales (R1 * R2,).  The
    caller (ops/omm.split_dyn) checks and allocates.  Raises on a refused
    launch."""
    import torch

    lib, _ = library()
    stream = torch.cuda.current_stream(A.device).cuda_stream
    err = lib.split_launch(A.device.index, A.data_ptr(), D.data_ptr(),
                           scale.data_ptr(), int(R1), int(k), int(R2),
                           int(kp), int(n_slices), stream)
    if err != 0:
        msg = lib.qphys_error_string(err).decode()
        raise RuntimeError(f"split kernel launch failed: {msg} ({err})")


# csrc/mass.cu's return code for a block that needs more shared memory than
# the card allows (mass_smem_bytes above mass_smem_limit)
MASS_TOO_LARGE = 20001


# tensor id -> (weak reference, version, values on the host)
_HOST_TABLES = {}


def host_table(B):
    """The values of the CUDA tensor B on the host, copied (one sync) the
    first time this tensor object is seen at its current version (an
    in-place change bumps it) and kept while the tensor lives: the compiled
    mass kernels take their 1D table as a kernel parameter."""
    if B.is_inference():        # no version counter: copied every call
        return B.detach().to("cpu", copy=True).contiguous()
    key = id(B)
    hit = _HOST_TABLES.get(key)
    if hit is not None and hit[0]() is B and hit[1] == B._version:
        return hit[2]
    host = B.detach().to("cpu", copy=True).contiguous()
    _HOST_TABLES[key] = (weakref.ref(B, lambda _, k=key: _HOST_TABLES.pop(k, None)),
                         B._version, host)
    return host


def _mass_error(err, code, dev, dim, nd1, nq1, dtype, what):
    """Raises for a refused launch of a mass kernel, naming the
    shared-memory limit when the size needs more than a block may have."""
    lib, _ = library()
    if err == MASS_TOO_LARGE:
        need = lib.mass_smem_bytes(code, int(dim), int(nd1), int(nq1))
        limit = lib.mass_smem_limit(dev)
        raise RuntimeError(
            f"{what}: (nd1, nq1) = ({nd1}, {nq1}) in {dim}D {dtype} "
            f"needs {need} bytes of shared memory a block, above the card's "
            f"limit of {limit} bytes (232,448 on an H100)")
    if err != 0:
        msg = lib.qphys_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def launch_mass(u, D, B, out, *, C, NE, dim, nd1, nq1, rt=False):
    """Launch csrc/mass.cu on PyTorch's current stream: out = B^T (D * (B u))
    per element and component, u and out (C, NE, nd1^dim), D (NE,
    nq1^dim), B (nq1, nd1), contiguous CUDA tensors of one dtype (f32 or
    f64) already checked and allocated by the caller (ops/mass.mass_apply_e);
    B's values also go to the kernel from the host (`host_table`).  `rt`
    runs the runtime-size kernel even where a compiled instance exists
    (chip_smoke.py times the two).  Raises on a refused launch, and names
    the shared-memory limit when the size needs more than a block may
    have."""
    import torch

    lib, _ = library()
    code = {torch.float32: 0, torch.float64: 1}[u.dtype]
    dev = u.device.index
    stream = torch.cuda.current_stream(u.device).cuda_stream
    table = host_table(B)
    err = lib.mass_launch(code, dev, u.data_ptr(), D.data_ptr(), B.data_ptr(),
                          table.data_ptr(), out.data_ptr(), int(C), int(NE),
                          int(dim), int(nd1), int(nq1), int(rt), stream)
    _mass_error(err, code, dev, dim, nd1, nq1, u.dtype, "mass kernel")


def launch_lattice_mass(u, Dq, B, table, ye, y, *, C, elems, nd1, nq1,
                        rt=False):
    """Launch csrc/lattice_mass.cu on PyTorch's current stream: y[c] =
    Tz' Ty' Tx' (Dq * Tx Ty Tz u[c]) on the raster lattice of `elems`
    (n_z, n_y, n_x) elements (fewer in 2D and 1D) of the table B (nq1,
    nd1): u and y (C, prod L) with L = n (nd1 - 1) + 1, Dq the q-lattice,
    ye the E-vector scratch (C, prod n, nd1^dim), contiguous CUDA tensors
    of one dtype (f32 or f64) checked and allocated by the caller
    (ops/lattice.mass_apply_lattice); `table` B's values on the host (the
    compiled instances take it as a kernel parameter).  `rt` runs the
    runtime-size body even where a compiled instance exists.  Raises on a
    refused launch."""
    import torch

    lib, _ = library()
    code = {torch.float32: 0, torch.float64: 1}[u.dtype]
    dev = u.device.index
    stream = torch.cuda.current_stream(u.device).cuda_stream
    dim = len(elems)
    nx, ny, nz = (tuple(reversed(elems)) + (1, 1))[:3]
    err = lib.lattice_mass_launch(
        code, dev, u.data_ptr(), Dq.data_ptr(), B.data_ptr(),
        table.data_ptr(), ye.data_ptr(), y.data_ptr(), int(C), dim,
        int(nd1), int(nq1), int(nx), int(ny), int(nz), int(rt), stream)
    _mass_error(err, code, dev, dim, nd1, nq1, u.dtype, "lattice mass kernel")


def mass_grid(dtype, device, *, dim, nd1, nq1):
    """The blocks csrc/mass.cu's compiled instance for (dim, nd1, nq1)
    launches at most on the card `device` (each walks groups of elements
    until none is left), or 0 where no instance is compiled (the
    runtime-size kernel: a block a group).  Raises on a CUDA error."""
    import torch

    lib, _ = library()
    code = {torch.float32: 0, torch.float64: 1}[dtype]
    grid = lib.mass_grid(code, int(device), int(dim), int(nd1), int(nq1))
    if grid < 0:
        msg = lib.qphys_error_string(int(-grid)).decode()
        raise RuntimeError(f"mass_grid failed: {msg} ({-grid})")
    return int(grid)


def _cg_operand(t, dtype, C, n, what):
    """(pointer, row stride) of the optional per-entry operand t, (n,)
    shared by the rows or (C, n), contiguous, of `dtype`; (None, 0) for
    None."""
    if t is None:
        return None, 0
    if t.dtype != dtype or not t.is_contiguous() or not t.is_cuda:
        raise ValueError(f"{what}: a contiguous CUDA {dtype} tensor, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if t.numel() == n:
        return t.data_ptr(), 0
    if t.numel() == C * n and t.dim() == 2:
        return t.data_ptr(), n
    raise ValueError(f"{what}: ({n},) or ({C}, {n}), got {tuple(t.shape)}")


class CGLaunch:
    """csrc/cg.cu bound to the tensors of one CG solve of C rows of n
    entries: x, r, d (C, n) updated in place; nom, den, r0, beta (C,) of
    their type, active (C,) bool, iters (C,) int64, flag a 0-d int32;
    dinv (the diagonal preconditioner) and ess (the essential-dof mask,
    bool) (n,) or (C, n), or None.  Checks them once and allocates the
    dots' partials; `step(it, Ad)` launches steps 1-3 of iteration `it`
    (update, finisher, direction), `ess_dot(y)` the mask written into the
    operator's output y (C, n) and den = (d, y) (y then holds Ad).  On
    PyTorch's current stream at construction; raises on a refused
    launch."""

    def __init__(self, x, r, d, nom, den, r0, active, iters, beta, flag,
                 dinv=None, ess=None):
        import torch

        dt, dev = x.dtype, x.device
        if dt not in (torch.float32, torch.float64) or x.dim() != 2:
            raise ValueError(f"CG chain: (C, n) f32 or f64, got {dt} "
                             f"{tuple(x.shape)}")
        C, n = x.shape
        for t in (x, r, d):
            if t.shape != x.shape or t.dtype != dt or t.device != dev \
                    or not t.is_contiguous():
                raise ValueError("CG chain: x, r, d contiguous (C, n) of "
                                 "one type on one card")
        for t, want in ((nom, dt), (den, dt), (r0, dt), (beta, dt),
                        (active, torch.bool), (iters, torch.int64)):
            if t.shape != (C,) or t.dtype != want or t.device != dev \
                    or not t.is_contiguous():
                raise ValueError(f"CG chain: a ({C},) {want} tensor, got "
                                 f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if flag.shape != () or flag.dtype != torch.int32 or flag.device != dev:
            raise ValueError("CG chain: the flag is a 0-d int32 tensor")
        dp, ds = _cg_operand(dinv, dt, C, n, "CG chain preconditioner")
        ep, es = _cg_operand(ess, torch.bool, C, n, "CG chain mask")
        lib, _ = library()
        code = {torch.float32: 0, torch.float64: 1}[dt]
        P = lib.cg_partials(code, dev.index, C, n)
        if P < 0:
            msg = lib.qphys_error_string(int(-P)).decode()
            raise RuntimeError(f"cg_partials failed: {msg} ({-P})")
        # the tensors whose pointers the launches take, kept alive here
        self._keep = (x, r, d, nom, den, r0, active, iters, beta, flag, dinv,
                      ess)
        self.partials = torch.empty((C, P), dtype=dt, device=dev)
        self.shape, self.dtype, self.device = (C, n), dt, dev
        stream = torch.cuda.current_stream(dev).cuda_stream
        self._lib = lib
        self._head = (code, dev.index, C, n, P)
        self._xrd = (x.data_ptr(), r.data_ptr(), d.data_ptr())
        self._step_tail = (dp, ds, nom.data_ptr(), den.data_ptr(),
                           r0.data_ptr(), active.data_ptr(), iters.data_ptr(),
                           beta.data_ptr(), self.partials.data_ptr(),
                           flag.data_ptr(), stream)
        self._dot_tail = (ep, es, d.data_ptr(), den.data_ptr(),
                          active.data_ptr(), self.partials.data_ptr(), stream)

    def _check(self, t, what):
        if t.shape != self.shape or t.dtype != self.dtype \
                or t.device != self.device or not t.is_contiguous():
            raise ValueError(f"CG chain: {what} must be a contiguous "
                             f"{self.shape} {self.dtype} tensor on "
                             f"{self.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")

    def step(self, it, Ad):
        self._check(Ad, "Ad")
        err = self._lib.cg_step_launch(*self._head, int(it), *self._xrd,
                                       Ad.data_ptr(), *self._step_tail)
        if err != 0:
            msg = self._lib.qphys_error_string(err).decode()
            raise RuntimeError(f"CG chain launch failed: {msg} ({err})")

    def ess_dot(self, y):
        self._check(y, "the operator's output")
        err = self._lib.cg_ess_dot_launch(*self._head, y.data_ptr(),
                                          *self._dot_tail)
        if err != 0:
            msg = self._lib.qphys_error_string(err).decode()
            raise RuntimeError(f"CG chain launch failed: {msg} ({err})")
