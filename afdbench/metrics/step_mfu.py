"""The whole step's share of the card's bf16 peak: the model FLOPs of every
token processed in the traced run's window before the profiler starts
(prefill chunk tokens and decode tokens of live requests;
``afdbench.work.token_flops``: 2 × the matmul parameters a token meets
plus attention over its live context) over that part's seconds × 989e12.
None off the card."""

LAYER = "whole step"
UNIT = "%"
MOVES = "itl_p95_s"


def read(t):
    from afdbench import work
    if t.profile is None or t.span_s <= 0:
        return None
    flops = sum(work.token_flops(t.arch, ctx) for ctx in t.decode_contexts)
    for n, start in t.prefill_chunks:
        flops += sum(work.token_flops(t.arch, start + j + 1)
                     for j in range(n))
    if flops == 0:
        return None
    return work.share_pct(flops / work.PEAK_FLOPS_BF16, t.span_s,
                          "step_mfu")
