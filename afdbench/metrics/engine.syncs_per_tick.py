"""Mean over ticks of the program's host waits on the device: the
``sync.*`` counts in each ``engine.tick`` span's subtree, over the traced
run's part before the profiler (``afdbench.program.syncs_per_tick``).
None where the run did not set the program's tracer."""

LAYER = "serving/afd_engine"
UNIT = "syncs"
MOVES = "itl_p95_s"


def read(t):
    from afdbench import program
    return program.syncs_per_tick(getattr(t, "program", None))
