"""Share of the traced window in which no operation ran on the device
(the union of the profiler's device ops against the window's length)."""

LAYER = "device"
UNIT = "%"
MOVES = "itl_p95_s"


def read(t):
    if t.profile is None or t.window_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - t.profile["busy_s"] / t.window_s)
