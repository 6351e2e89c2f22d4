"""Share of the energy CG's iterations run by the fused chain
(`laghos_tpu_torch/csrc/cg.cu`), in percent, by the program's own
counter: `timing.Tracer.cg_iters` counts each solve's iterations by the
innermost range open ("laghos.cg_l2") and the path that ran them ("fused"
or "generic").  Read over the timed steps of the traced phases
(`driver.run(timing=True)`, the last `timing.trace` of the run).  None
where the program has no such counter, or ran no such iteration."""

LAYER = "CG-L2"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_counter"
MOVES = "fom"
SPAN = "laghos.cg_l2"


def read(tr):
    if not tr.timed_steps:
        return None
    try:
        from laghos_tpu_torch import timing
    except ImportError:
        return None
    last = getattr(timing, "last_trace", None)
    t = last() if last is not None else None
    counts = getattr(t, "cg_iters", None)
    if not counts:
        return None
    fused = counts.get((SPAN, "fused"), 0)
    total = fused + counts.get((SPAN, "generic"), 0)
    return 100.0 * fused / total if total else None
