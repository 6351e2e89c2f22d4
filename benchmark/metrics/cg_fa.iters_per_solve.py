"""Iterations a solve of the full-assembly velocity CG (one coupled
Jacobi-PCG over every component, Hydro._cg_velocity_fa), by the program's
own counters: `timing.Tracer.cg_iters` and `cg_solves` count each solve
and its iterations by the innermost range open and the path that ran it.
Under -fa the one solve inside "laghos.cg_h1" is this one, so this is that
range's iterations, on every path, over its solves.  Read over the timed
steps of the traced phases (`driver.run(timing=True)`, the last
`timing.trace` of the run).  None where the program has no such counter,
or ran no such solve."""

LAYER = "CG-FA"
UNIT = "iters"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "fom"
SPAN = "laghos.cg_h1"


def read(tr):
    if not tr.timed_steps:
        return None
    try:
        from laghos_tpu_torch import timing
    except ImportError:
        return None
    last = getattr(timing, "last_trace", None)
    t = last() if last is not None else None
    solves = getattr(t, "cg_solves", None)
    if not solves:
        return None
    n = sum(v for (span, _), v in solves.items() if span == SPAN)
    iters = sum(v for (span, _), v in t.cg_iters.items() if span == SPAN)
    return iters / n if n else None
