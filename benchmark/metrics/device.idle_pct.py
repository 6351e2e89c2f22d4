"""Share of the profiled steps' wall time in which no operation ran on the
device: 1 - the union of the device intervals over the window between
the first and the last step mark."""

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "fom"


def read(tr):
    p = tr.profile
    if p is None or p["window_us"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_us"] / p["window_us"])
