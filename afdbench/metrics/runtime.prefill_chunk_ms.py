"""Mean host wall of ``AFDRuntime.prefill`` (one prompt chunk through the
whole stack) in the traced run's window before the profiler starts,
sync-ended."""

LAYER = "parallel/afd"
UNIT = "ms"
MOVES = "itl_p95_s"


def read(t):
    walls = t.walls.get("runtime.prefill", [])
    return 1e3 * sum(walls) / len(walls) if walls else None
