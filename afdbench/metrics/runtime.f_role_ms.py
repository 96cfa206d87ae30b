"""Mean host ms of the F role per 3BO rotation: the ``afd.f.experts``
spans under each ``engine.rotation`` span, over the traced run's part
before the profiler (``afdbench.program.role_ms``). None where the run
did not set the program's tracer."""

LAYER = "parallel/afd"
UNIT = "ms"
MOVES = "itl_p95_s"


def read(t):
    from afdbench import program
    return program.role_ms(getattr(t, "program", None), "f")
