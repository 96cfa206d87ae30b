"""Mean host ms of the engine's own work in a tick: each ``engine.tick``
span of the program (``repro_torch.trace``) less its ``engine.prefill``
and ``engine.rotation``, over the traced run's part before the profiler
(``afdbench.program.tick_self_ms``). None where the run did not set the
program's tracer."""

LAYER = "serving/afd_engine"
UNIT = "ms"
MOVES = "itl_p95_s"


def read(t):
    from afdbench import program
    return program.tick_self_ms(getattr(t, "program", None))
