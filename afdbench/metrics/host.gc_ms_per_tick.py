"""Host ms of Python's collections per tick: the program's ``gc.collect``
spans over its ``engine.tick`` spans, in the traced run's part before the
profiler (``afdbench.program.gc_ms_per_tick``). None where the run did
not set the program's tracer."""

LAYER = "host"
UNIT = "ms"
MOVES = "itl_p95_s"


def read(t):
    from afdbench import program
    return program.gc_ms_per_tick(getattr(t, "program", None))
