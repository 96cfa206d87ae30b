"""Mean host wall of ``AFDServeEngine.tick`` in the traced run's window
before the profiler starts, each call ended by a device sync
(``afdbench.tracing.Spans``)."""

LAYER = "serving/afd_engine"
UNIT = "ms"
MOVES = "itl_p95_s"


def read(t):
    walls = t.walls.get("engine.tick", [])
    return 1e3 * sum(walls) / len(walls) if walls else None
