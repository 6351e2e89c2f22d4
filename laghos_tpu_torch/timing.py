"""Phase timers and figure-of-merit reporting.

Equivalent of the reference's TimingData/PrintTimingData
(laghos_solver.hpp:39-56, laghos_solver.cpp:699-796): wall-clock stopwatches
around the four major phases (CG-H1, CG-L2, forces, qdata) with device
fences (`block`, the analog of LAGHOS_DEVICE_SYNC), and the FOM rates:
    FOM1 = 1e-6 * H1_dofs * cg_iters / T_cgH1
    FOM2 = 1e-6 * steps * (H1 + L2 dofs) / T_force
    FOM3 = 1e-6 * quads * steps / T_qdata
    FOM  = time-weighted mix, FOM0 = 1e-6 * steps * (H1+L2) / (T1+T2+T3)

The stopwatches run in the same hook as the tracer (`trace`): the layer
spans of a step on torch.profiler's clock, a count of the host's reads
of device values by the layer that made them, and a count of the CG
iterations and solves by layer and by the path that ran them.
"""

from __future__ import annotations

import collections
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

    def count(self, timer, out, NE):
        """The FOM counts of one timed phase call: the elements of a
        q-update, the CG iterations of a solve (`out[1]`).  The iterations
        add up on the device; `settle` reads them when the run ends, so the
        timed steps read the device no more often than untimed ones."""
        if timer == "qdata":
            self.quad_tstep += NE
        elif timer == "cgH1":
            self.H1iter = self.H1iter + out[1]
        elif timer == "cgL2":
            self.L2iter = self.L2iter + out[1]

    def settle(self):
        """Read the iteration totals to the host."""
        if isinstance(self.H1iter, torch.Tensor):
            self.H1iter = host_read(self.H1iter)
        if isinstance(self.L2iter, torch.Tensor):
            self.L2iter = host_read(self.L2iter)


# The tracer of the code running inside `trace`, or None.  Every hook on
# the main path (`span`, `host_read`, `count_cg`, `attempt`, `charge` and
# the phases of `hydro._phase`) tests it once and, while it is None, does
# nothing more.
TRACER = None
_LAST = None
_OFF = contextlib.nullcontext()

# the layer of each program span: every other span ("laghos.step",
# "laghos.dt_read", "laghos.vis"), and host time in none, is the driver's;
# "laghos.spmv" opens inside "laghos.cg_h1" only
LAYER_OF = {"laghos.qdata": "qdata", "laghos.force": "force",
            "laghos.cg_h1": "cg_h1", "laghos.cg_l2": "cg_l2",
            "laghos.spmv": "cg_h1"}
LAYERS = ("qdata", "force", "cg_h1", "cg_l2", "driver")
# the TimingData timer a phase's span charges in the driver's timing mode
_TIMER_OF = {"laghos.qdata": "qdata", "laghos.force": "force",
             "laghos.cg_h1": "cgH1", "laghos.cg_l2": "cgL2"}


class Tracer:
    """What `trace` records: the host reads of device values by the
    innermost span open when each was made ("" outside every span), the
    CG iterations and solves by (innermost span, path: "fused" for
    csrc/cg.cu's chain, "generic" for the eager iteration) in `cg_iters`
    and `cg_solves`, one (step, accepted) a `laghos.step` span in the
    order they ran, and, in the driver's timing mode, the TimingData the
    phases charge (`tim`).

    torch.profiler keeps no argument of a range (`record_function`'s
    `args` reach neither its events nor its trace), so whether an attempt
    was accepted is kept here: the k-th entry of `attempts` is the k-th
    `laghos.step` range."""

    def __init__(self):
        self.reads = collections.Counter()
        self.cg_iters = collections.Counter()
        self.cg_solves = collections.Counter()
        self.attempts = []
        self.tim = None
        self._open = []

    @contextlib.contextmanager
    def span(self, name):
        """A torch.profiler range `name` (the enclosing range on this
        thread is its parent) that the reads inside are counted against."""
        self._open.append(name)
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            self._open.pop()

    @contextlib.contextmanager
    def charging(self, tim):
        prev, self.tim = self.tim, tim
        try:
            yield
        finally:
            self.tim = prev

    def phase(self, name, hydro, fn, *args, **kw):
        """`fn(hydro, *args, **kw)` in the layer span `name`; while
        charging a TimingData, fenced on both sides, its wall time added to
        the span's timer and its FOM counts to the TimingData's."""
        with self.span(name):
            tim = self.tim
            if tim is None:
                return fn(hydro, *args, **kw)
            _fence(hydro.device)
            t0 = time.perf_counter()
            out = fn(hydro, *args, **kw)
            _fence(hydro.device)
            timer = _TIMER_OF[name]
            tim.t[timer] += time.perf_counter() - t0
            tim.count(timer, out, hydro.NE)
            return out

    def reads_by_layer(self):
        """{layer: host reads} over LAYERS."""
        out = dict.fromkeys(LAYERS, 0)
        for name, n in self.reads.items():
            out[LAYER_OF.get(name, "driver")] += n
        return out

    def accepted(self):
        return sum(ok for _, ok in self.attempts)

    def summary(self):
        """One line: the reads by layer and the attempts."""
        by = self.reads_by_layer()
        n = self.accepted()
        return (f"host reads {sum(by.values())}: " + ", ".join(
            f"{k} {v}" for k, v in by.items()) + f"; attempts "
            f"{len(self.attempts)} ({n} accepted, "
            f"{len(self.attempts) - n} rejected)")


@contextlib.contextmanager
def trace():
    """Turn the tracer on for the enclosed code and yield it (inside
    another `trace`, the one already on).  While it is on, each layer of
    the step runs in a torch.profiler range ("laghos.qdata",
    "laghos.force", "laghos.cg_h1", "laghos.cg_l2", and inside
    "laghos.cg_h1" the full-assembly solve's "laghos.spmv"; the driver's
    "laghos.step" per attempt, "laghos.dt_read", "laghos.vis"), and every
    read of a device value on the main path (`host_read`) is counted."""
    global TRACER, _LAST
    if TRACER is not None:
        yield TRACER
        return
    TRACER = tr = Tracer()
    try:
        yield tr
    finally:
        TRACER = None
        _LAST = tr


def last_trace():
    """The tracer of the last `trace` block to end in this process, or
    None: what a reader of the counters finds after the run."""
    return _LAST


def span(name):
    """The span `name` while tracing; otherwise a shared no-op context."""
    tr = TRACER
    return _OFF if tr is None else tr.span(name)


def charge(tim):
    """While tracing, the phases inside charge the TimingData `tim` (None:
    nothing)."""
    tr = TRACER
    return _OFF if tr is None or tim is None else tr.charging(tim)


def host_read(x):
    """The host reads the device value `x`: a Python number for a 0-d
    tensor (`item`), else `tolist`; counted against the innermost open
    span while tracing.  Every read of the main path goes through here."""
    tr = TRACER
    if tr is not None:
        tr.reads[tr._open[-1] if tr._open else ""] += 1
    return x.tolist() if x.dim() else x.item()


def count_cg(path, n):
    """While tracing, count one CG solve of `n` iterations run on `path`
    ("fused" or "generic") against the innermost open span."""
    tr = TRACER
    if tr is not None:
        key = (tr._open[-1] if tr._open else "", path)
        tr.cg_iters[key] += n
        tr.cg_solves[key] += 1


def attempt(step, accepted):
    """Record the outcome of the attempt at `step` while tracing."""
    tr = TRACER
    if tr is not None:
        tr.attempts.append((step, accepted))


def _fence(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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


def device_ms(fn, n=20, cold=False, before=None):
    """Median device time in ms of n calls of fn on the card, each between
    two CUDA events.  Before each call the card is kept busy for ~1 ms
    (`torch.cuda._sleep`) while the host queues it, so a call that costs
    the host longer than the card to launch is timed by its device work,
    not its launch.  cold: before each call, outside the events, write a
    128 MiB buffer (2.7x the 50 MB L2), so the call finds its inputs in
    device memory.  before: called before each call (and before the
    buffer is written), outside the events: to restore the state a call
    of fn changes."""
    if cold and not _FLUSH:
        _FLUSH.append(torch.empty(2**25, dtype=torch.float32, device="cuda"))
    if before is not None:
        before()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        if before is not None:
            before()
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
