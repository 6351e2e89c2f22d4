"""Energy CG (Hydro._cg_energy) ms an accepted step, by the program's fenced
phase timer "cgL2"."""

LAYER = "CG-L2"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "fom"


def read(tr):
    return tr.ms_per_step("cgL2")
