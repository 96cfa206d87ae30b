"""Mean host ms of the stepped Mamba mixers per prefill chunk: the
``afd.a.mamba_chunk`` spans under each ``engine.prefill`` span that ran
one, over the traced run's part before the profiler
(``afdbench.program.mamba_chunk_ms``). None where the run did not set the
program's tracer or stepped no Mamba chunk."""

LAYER = "parallel/afd"
UNIT = "ms"
MOVES = "tokens_per_s"


def read(t):
    from afdbench import program
    return program.mamba_chunk_ms(getattr(t, "program", None))
