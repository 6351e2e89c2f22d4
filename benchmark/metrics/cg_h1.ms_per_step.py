"""Velocity CG (solvers/cg on Hydro._h1_apply_bc) ms an accepted step, by
the program's fenced phase timer "cgH1" (driver.run(timing=True))."""

LAYER = "CG-H1"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "fom"


def read(tr):
    return tr.ms_per_step("cgH1")
