"""Host syncs an accepted step of the host loop (driver.run, the CGs' flag
reads), by the program's counter `timing.count_syncs`: two resumed runs
under it, the second with more steps, and the difference over their
difference in accepted steps, so that each run's fixed syncs cancel."""

LAYER = "driver"
UNIT = "syncs/step"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "fom"


def read(tr):
    return tr.syncs_per_step
