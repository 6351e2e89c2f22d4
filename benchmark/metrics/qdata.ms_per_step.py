"""q-update (ops/lattice.qupdate3d_lattice: the gradients and the q-point
physics) ms an accepted step, by the program's fenced phase timer
"qdata"."""

LAYER = "q-data"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "fom"


def read(tr):
    return tr.ms_per_step("qdata")
