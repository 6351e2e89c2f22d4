"""The program's layer ranges joined with the device's events of a
torch.profiler window between the first and the last step mark: every
device-busy and every device-idle microsecond of the window put down to
one layer.

The program opens a torch.profiler range at each layer boundary while its
tracer is on (`laghos_tpu_torch.timing.trace`): "laghos.qdata",
"laghos.force", "laghos.cg_h1" and "laghos.cg_l2" around the step's
phases, and the driver's "laghos.step" (one an attempt), "laghos.dt_read"
and "laghos.vis".

- busy: each device interval goes to the layer of the innermost program
  range open on the host when its launch was made.  The launch is the
  host's runtime call (cudaLaunchKernel, cudaMemcpyAsync, ...) with the
  device event's correlation id; device events that match none are paired
  in order with the launch calls left over, the k-th with the k-th, as the
  program's single in-order stream runs them.  Where device intervals
  overlap, each microsecond goes to the one that started first, so the
  busy times add up to the union of the device intervals.
- idle: each stretch of the window in which no device interval runs is
  split over the innermost program ranges open on the host during it, in
  proportion to their overlap.

Host time in no layer range (in none at all, or in the driver's) is the
driver's, so the five busy and the five idle times add up to the window.
"""

from __future__ import annotations

import bisect
from collections import Counter

import torch

from . import profiling

PREFIX = "laghos."
LAYER_OF = {"laghos.qdata": "qdata", "laghos.force": "force",
            "laghos.cg_h1": "cg_h1", "laghos.cg_l2": "cg_l2"}
LAYERS = ("qdata", "force", "cg_h1", "cg_l2", "driver")
_LAUNCH_WORDS = ("Launch", "Memcpy", "Memset")


def from_events(events):
    """(ranges, launches, device) of profiler events: the program's ranges
    as (start, end, name); the host's runtime launch calls as (start, id);
    the device's events as (start, end, id, name).  With CUDA activity the
    profiler also draws each range on the device's timeline, over the
    kernels it launched: those copies are no device work and are left
    out."""
    ranges, launches, device = [], [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.name.startswith(PREFIX):
                device.append((s, t, e.id, e.name))
        elif e.name.startswith(PREFIX):
            ranges.append((s, t, e.name))
        elif e.name.startswith("cu") and any(w in e.name
                                             for w in _LAUNCH_WORDS):
            launches.append((s, e.id))
    return ranges, launches, device


def segments(ranges, lo, hi):
    """[(a, b, layer)]: [lo, hi] cut where the innermost open range (the
    latest started of those open; ranges on one thread nest) changes,
    each piece with that range's layer ("driver" for none)."""
    cuts = sorted({lo, hi} | {x for s, t, _ in ranges for x in (s, t)
                              if lo < x < hi})
    out = []
    for a, b in zip(cuts, cuts[1:]):
        m = 0.5 * (a + b)
        inner = max(((s, n) for s, t, n in ranges if s <= m < t),
                    default=None)
        layer = "driver" if inner is None else LAYER_OF.get(inner[1],
                                                            "driver")
        if out and out[-1][2] == layer:
            out[-1][1] = b
        else:
            out.append([a, b, layer])
    return [tuple(p) for p in out]


def _layer_at(segs, starts, x):
    i = bisect.bisect_right(starts, x) - 1
    return segs[i][2] if 0 <= i < len(segs) else "driver"


def place(launches, device):
    """[(start, end, launch time or None)] of the device events: by
    correlation id, then the rest in order with the unmatched launches.
    Also {"correlation": n, "order": n, "none": n, "unmatched": the names
    of the device events placed by order or not at all, most first}."""
    by_id = {}
    for s, i in launches:
        if i:
            by_id.setdefault(i, s)
    used = set()
    out, rest = [], []
    for s, t, i, name in sorted(device, key=lambda d: (d[0], d[1])):
        if i and i in by_id:
            out.append((s, t, by_id[i]))
            used.add(i)
        else:
            rest.append((s, t, name))
    left = sorted(s for s, i in launches if not (i and i in used))
    n = {"correlation": len(out), "order": min(len(rest), len(left)),
         "none": max(0, len(rest) - len(left)),
         "unmatched": Counter(name[:60] for *_, name in rest).most_common(5)}
    for k, (s, t, _) in enumerate(rest):
        out.append((s, t, left[k] if k < len(left) else None))
    return out, n


def join(ranges, launches, device, lo, hi):
    """{busy_us, idle_us (layer -> us), window_us, placed} of [lo, hi]."""
    first = min([lo] + [s for s, _ in launches] + [s for s, _, _ in ranges])
    segs = segments(ranges, first, hi)
    starts = [a for a, _, _ in segs]
    placed, n = place(launches, device)
    busy = dict.fromkeys(LAYERS, 0.0)
    cur = lo
    for s, t, at in sorted(placed, key=lambda p: (p[0], p[1])):
        s, t = max(s, cur), min(t, hi)
        if t > s:
            layer = "driver" if at is None else _layer_at(segs, starts, at)
            busy[layer] += t - s
            cur = t
    idle = dict.fromkeys(LAYERS, 0.0)
    gaps, cur = [], lo
    for s, t in profiling.merged([(max(s, lo), min(t, hi))
                                  for s, t, *_ in device
                                  if min(t, hi) > max(s, lo)]):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, t)
    if hi > cur:
        gaps.append((cur, hi))
    for a, b in gaps:
        i = max(0, bisect.bisect_right(starts, a) - 1)
        while i < len(segs) and segs[i][0] < b:
            s, t, layer = segs[i]
            idle[layer] += max(0.0, min(t, b) - max(s, a))
            i += 1
    return {"busy_us": busy, "idle_us": idle, "window_us": hi - lo,
            "placed": n}


def window(events):
    """`join` over the whole steps between the first and the last mark of
    a profiled run (profiling.MARK), with their number."""
    m = profiling.marks(events)
    if len(m) < 2:
        raise RuntimeError("the profiled window holds fewer than 2 marks")
    out = join(*from_events(events), m[0], m[-1])
    out["steps"] = len(m) - 1
    return out


def traced_steps(driver, timing, h, t_final, last, dt, steps):
    """`steps` more steps of the host loop from the accepted step `last` =
    (step, t, S) at `dt`, under torch.profiler with the program's tracer on
    and a mark after each step.  Returns (the window's `join` with the
    tracer's counts, or None where the program has no tracer; the last
    accepted step and dt after)."""
    from torch.profiler import ProfilerActivity, profile

    trace = getattr(timing, "trace", None)
    if trace is None:
        return None, (last, dt)
    acts = [ProfilerActivity.CPU]
    if last[2]["x"].is_cuda:
        acts.append(ProfilerActivity.CUDA)

    def mark(ti, t, S):
        with torch.profiler.record_function(profiling.MARK):
            pass

    step, t, S = last
    with profile(activities=acts) as prof, trace() as tr:
        res = driver.run(h, t_final, max_steps=steps, S_init=S, t_init=t,
                         dt_init=dt, step_init=step + 1, vis_steps=1,
                         on_vis=mark)
    out = window(prof.events())
    out["reads"] = tr.reads_by_layer()
    out["reads_outside_ranges"] = tr.reads.get("", 0)
    out["accepted"] = tr.accepted()
    out["attempts"] = len(tr.attempts)
    return out, ((res.steps, res.t, res.S), res.dt)
