"""Mean host wall of ``AFDRuntime.decode_step_3bo`` (one 3BO decode
rotation over every micro-batch) in the traced run's window before the
profiler starts, sync-ended."""

LAYER = "parallel/afd"
UNIT = "ms"
MOVES = "itl_p95_s"


def read(t):
    walls = t.walls.get("runtime.decode_step_3bo", [])
    return 1e3 * sum(walls) / len(walls) if walls else None
