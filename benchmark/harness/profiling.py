"""What a torch.profiler window says: device busy time, device time by
kernel, and the breakdown the result line carries.

The union of device intervals follows `laghos_tpu_torch.profile_steps._busy`
and the device time by kernel name `profile_steps.hand_kernel_times`
(laghos_tpu_torch/profile_steps.py:51-80): the hand-written kernels are
launched through ctypes, so they are no torch ops and only their device
events name them.  Here both are taken between two host marks, so that
the window is whole steps."""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

MARK = "bench.step"


def _is_device(e):
    return e.device_type == torch.autograd.DeviceType.CUDA


def marks(events):
    """Start times (us) of the host marks, in order."""
    return sorted(e.time_range.start for e in events if e.name == MARK)


def device_events(events, lo, hi):
    """(start, end, name) of the device events inside [lo, hi], clipped."""
    out = []
    for e in events:
        if _is_device(e):
            s, t = max(e.time_range.start, lo), min(e.time_range.end, hi)
            if t > s:
                out.append((s, t, e.name))
    return out


def merged(iv):
    """The union of intervals (start, end, ...) as sorted disjoint
    (start, end) pairs."""
    out = []
    for s, t, *_ in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def by_name(dev):
    """{kernel name: [device us, launches]}."""
    acc = defaultdict(lambda: [0.0, 0])
    for s, t, name in dev:
        acc[name][0] += t - s
        acc[name][1] += 1
    return dict(acc)


def idle_gaps(events, busy, lo, hi, top=10):
    """The longest idle stretches of the device between lo and hi, summed
    by what the host was doing then: the innermost host event (the latest
    started that still runs) at the middle of each gap, "python" where
    none runs.  [[host activity, seconds], ...], longest first."""
    host = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events if not _is_device(e) and e.name != MARK)
    starts = [h[0] for h in host]
    gaps = []
    cur = lo
    for s, t in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, t)
    if hi > cur:
        gaps.append((cur, hi))
    acc = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid)
        name = "python"
        for s, t, n in reversed(host[max(0, i - 400):i]):
            if t >= mid:
                name = n
                break
        acc[name] += (b - a) / 1e6
    return sorted(([k[:120], v] for k, v in acc.items()),
                  key=lambda r: -r[1])[:top]


def window(prof):
    """Summary of a profiled run of steps with a mark at the end of each:
    the whole steps between the first and the last mark."""
    ev = prof.events()
    m = marks(ev)
    if len(m) < 2:
        raise RuntimeError("the profiled window holds fewer than 2 marks")
    lo, hi = m[0], m[-1]
    dev = device_events(ev, lo, hi)
    busy = merged(dev)
    names = by_name(dev)
    return {
        "steps": len(m) - 1,
        "window_us": hi - lo,
        "busy_us": sum(t - s for s, t in busy),
        "kernels": names,
        "device_ops": sorted(([k[:120], v[0] / 1e6]
                              for k, v in names.items()),
                             key=lambda r: -r[1])[:10],
        "idle_gaps": idle_gaps(ev, busy, lo, hi),
    }
