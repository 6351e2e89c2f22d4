"""Force pair (F . 1 and F^T . v, ops/lattice) ms an accepted step, by the
program's fenced phase timer "force"."""

LAYER = "force"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "fom"


def read(tr):
    return tr.ms_per_step("force")
