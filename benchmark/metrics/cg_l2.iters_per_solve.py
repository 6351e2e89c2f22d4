"""Energy CG iterations a solve: RunResult.l2_iters of the timed steps over
their solves (stages a step)."""

LAYER = "CG-L2"
UNIT = "iters"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "fom"


def read(tr):
    if not tr.timed_steps:
        return None
    return tr.l2_iters / (tr.timed_steps * tr.stages)
