"""Velocity CG iterations a component solve: RunResult.h1_iters of the
timed steps over their solves (stages a step times dim components)."""

LAYER = "CG-H1"
UNIT = "iters"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "fom"


def read(tr):
    if not tr.timed_steps:
        return None
    return tr.h1_iters / (tr.timed_steps * tr.stages * tr.shape["dim"])
