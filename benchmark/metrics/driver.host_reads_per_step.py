"""Host reads of device values an accepted step of the host loop, by the
program's own counter: every read on the main path goes through
`laghos_tpu_torch.timing.host_read`, which the program's tracer counts
against the innermost range open (`timing.trace`).  The timed steps of the
traced phases (`driver.run(timing=True)`) run with the tracer on; this is
the reads made inside the program's ranges there, over their accepted
steps.  The reads outside every range (the energies at both ends of a run)
are left out, as the two-run difference of driver.syncs_per_step leaves a
run's fixed syncs out; the run's last step reads |e| once more than the
others (its vis step).  None where the program has no such counter."""

LAYER = "driver"
UNIT = "reads/step"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "fom"


def read(tr):
    if not tr.timed_steps:
        return None
    try:
        from laghos_tpu_torch import timing
    except ImportError:
        return None
    last = getattr(timing, "last_trace", None)
    t = last() if last is not None else None
    if t is None or not t.accepted():
        return None
    return (sum(t.reads.values()) - t.reads.get("", 0)) / t.accepted()
