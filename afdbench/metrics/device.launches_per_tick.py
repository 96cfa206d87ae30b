"""Device operations the profiler saw in the traced window (every kernel,
copy and fill, glue included) per engine tick."""

LAYER = "device"
UNIT = "launches"
MOVES = "itl_p95_s"


def read(t):
    if t.profile is None or not t.ticks:
        return None
    return t.profile["device_ops"] / t.ticks
