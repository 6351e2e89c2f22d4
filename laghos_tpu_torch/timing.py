"""Phase timers and figure-of-merit reporting.

Equivalent of the reference's TimingData/PrintTimingData
(laghos_solver.hpp:39-56, laghos_solver.cpp:699-796): wall-clock stopwatches
around the four major phases (CG-H1, CG-L2, forces, qdata) with device
fences (`block`, the analog of LAGHOS_DEVICE_SYNC), and the FOM rates:
    FOM1 = 1e-6 * H1_dofs * cg_iters / T_cgH1
    FOM2 = 1e-6 * steps * (H1 + L2 dofs) / T_force
    FOM3 = 1e-6 * quads * steps / T_qdata
    FOM  = time-weighted mix, FOM0 = 1e-6 * steps * (H1+L2) / (T1+T2+T3)
"""

from __future__ import annotations

import contextlib
import statistics
import time
import warnings

import torch


class TimingData:
    def __init__(self):
        self.t = {"cgH1": 0.0, "cgL2": 0.0, "force": 0.0, "qdata": 0.0}
        self.H1iter = 0
        self.L2iter = 0
        self.quad_tstep = 0

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        yield
        self.t[name] += time.perf_counter() - t0


def _cuda_devices(x, out):
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _cuda_devices(v, out)
    return out


def block(x):
    """Device fence (LAGHOS_DEVICE_SYNC equivalent): wait for the CUDA
    devices holding any tensor in `x` (a tensor or a tuple/list/dict of
    them), then return `x`.  CPU tensors are already computed."""
    for dev in _cuda_devices(x, set()):
        torch.cuda.synchronize(dev)
    return x


def print_timing(tim: TimingData, *, steps: int, H1_dofs: int, L2_dofs: int,
                 NQ: int, NE: int, p_assembly: bool, dim: int,
                 fom_table: bool, ranks: int = 1, out=print):
    """Mirror of PrintTimingData (laghos_solver.cpp:699-778)."""
    T1, TL2, T2, T3 = (tim.t["cgH1"], tim.t["cgL2"], tim.t["force"],
                       tim.t["qdata"])
    TT = T1 + T2 + T3

    def rate(num, den):
        return num / den if den > 0 else 0.0

    H1iter = tim.H1iter // dim if p_assembly else tim.H1iter
    FOM1 = rate(1e-6 * H1_dofs * H1iter, T1)
    FOM2 = rate(1e-6 * steps * (H1_dofs + L2_dofs), T2)
    FOM3 = rate(1e-6 * tim.quad_tstep * NQ, T3)
    FOM = rate(FOM1 * T1 + FOM2 * T2 + FOM3 * T3, TT)
    FOM0 = rate(1e-6 * steps * (H1_dofs + L2_dofs), TT)
    out("")
    out(f"CG (H1) total time: {T1}")
    out(f"CG (H1) rate (megadofs x cg_iterations / second): {FOM1}")
    out("")
    out(f"CG (L2) total time: {TL2}")
    out("CG (L2) rate (megadofs x cg_iterations / second): "
        f"{rate(1e-6 * L2_dofs * tim.L2iter, TL2)}")
    out("")
    out(f"Forces total time: {T2}")
    out(f"Forces rate (megadofs x timesteps / second): {FOM2}")
    out("")
    out(f"UpdateQuadData total time: {T3}")
    out(f"UpdateQuadData rate (megaquads x timesteps / second): {FOM3}")
    out("")
    out(f"Major kernels total time (seconds): {TT}")
    out(f"Major kernels total rate (megadofs x time steps / second): {FOM}")
    result = {
        "FOM0": FOM0, "FOM1": FOM1, "FOM2": FOM2, "FOM3": FOM3, "FOM": FOM,
        "T1": T1, "T2": T2, "T3": T3, "TT": TT,
    }
    if fom_table:
        ndofs = 2 * H1_dofs + L2_dofs + NQ * NE
        out("")
        out("| Ranks | Zones   | H1 dofs | L2 dofs | QP | N dofs   | FOM0   "
            "| FOM1   | T1   | FOM2   | T2   | FOM3   | T3   | FOM    | TT   |")
        out(f"| {ranks:6d}| {NE:8d}| {H1_dofs:8d}| {L2_dofs:8d}| {NQ:3d}"
            f"| {ndofs:9d}| {FOM0:7.3g}| {FOM1:7.3g}| {T1:5.3g}"
            f"| {FOM2:7.3g}| {T2:5.3g}| {FOM3:7.3g}| {T3:5.3g}"
            f"| {FOM:7.3g}| {TT:5.3g}|")
    return result


def run_metadata(*, args=None, opt=None, result=None, extra=None,
                 device=None):
    """Adiak-style run-provenance record (laghos.cpp:1288-1346), as
    `laghos_tpu.timing.run_metadata`: the CLI configuration, the Options,
    library versions, host and device identity and the FOM figures, as one
    JSON-ready dict (the CLI writes it to laghos_run_metadata.json with
    -f)."""
    import dataclasses
    import datetime
    import os
    import platform
    import sys

    rec = {
        "launchdate": datetime.datetime.now().isoformat(timespec="seconds"),
        "cmdline": sys.argv,
        "cluster": platform.node(),
        "executable": os.path.abspath(sys.argv[0]) if sys.argv else "",
        "user": os.environ.get("USER", ""),
        "python": platform.python_version(),
        "platform": platform.platform(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
    }
    if device is not None:
        device = torch.device(device)
        rec["device"] = str(device)
        if device.type == "cuda":
            rec["device_name"] = torch.cuda.get_device_name(device)
            rec["device_count"] = torch.cuda.device_count()
    if args is not None:
        rec["config"] = {k: v for k, v in sorted(vars(args).items())}
    if opt is not None:
        rec["options"] = dataclasses.asdict(opt)
    if result is not None:
        rec["fom"] = result
    if extra:
        rec.update(extra)
    return rec


_FLUSH = []


def device_ms(fn, n=20, cold=False):
    """Median device time in ms of n calls of fn on the card, each between
    two CUDA events.  Before each call the card is kept busy for ~1 ms
    (`torch.cuda._sleep`) while the host queues it, so a call that costs
    the host longer than the card to launch is timed by its device work,
    not its launch.  cold: before each call, outside the events, write a
    128 MiB buffer (2.7x the 50 MB L2), so the call finds its inputs in
    device memory."""
    if cold and not _FLUSH:
        _FLUSH.append(torch.empty(2**25, dtype=torch.float32, device="cuda"))
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        if cold:
            _FLUSH[0].fill_(1.0)
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


@contextlib.contextmanager
def count_syncs():
    """Count the host syncs the enclosed code makes on the card: under
    torch.cuda.set_sync_debug_mode("warn") every synchronizing CUDA call
    torch makes (a read of a device value such as bool() or .tolist(), a
    blocking copy, a synchronize) raises a warning, and the yielded dict's
    "syncs" holds their number when the block ends.  Counting costs one
    Python warning a sync; time runs without it."""
    out = {"syncs": 0}
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield out
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    out["syncs"] = sum("synchroniz" in str(w.message) for w in seen)
