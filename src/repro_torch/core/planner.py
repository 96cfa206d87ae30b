"""The Eq. 9/17 M2N wire model the serving engine checks its measured
dispatch/combine bytes against. A copy of the two predictors of
``repro.core.planner``; the rest of the planner is not ported yet.
"""

from __future__ import annotations


def predict_m2n_cycle_bytes(n_tokens: int, hidden: int, top_k: int,
                            dtype_bytes: int = 4, gate_bytes: int = 4,
                            idx_bytes: int = 4) -> tuple:
    """(dispatch, combine) bytes of ONE M2N cycle at the engine's dtypes.

    The Eq. 17 wire model evaluated at what the runtime actually ships:
    per cycle ``n_tokens`` hidden vectors each way plus the gating metadata
    (top-k weights + indices) on the dispatch leg. Must stay in lockstep
    with ``repro_torch.parallel.afd.AFDStats.record`` — the serving
    engine asserts the measured counters match this prediction *exactly*
    per window.
    """
    payload = n_tokens * hidden * dtype_bytes
    meta = n_tokens * top_k * (gate_bytes + idx_bytes)
    return payload + meta, payload


def predict_prefill_window_bytes(prefill_tokens: int, hidden: int,
                                 top_k: int, dtype_bytes: int = 4,
                                 gate_bytes: int = 4,
                                 idx_bytes: int = 4) -> tuple:
    """(dispatch, combine) bytes one MoE layer ships for a window's
    prefill work, for ANY chunking of those tokens.

    Eq. 17's cycle cost is an integer-linear function of the cycle's token
    count, so summing ``predict_m2n_cycle_bytes`` over chunks c_1..c_m
    with Σc_i = prefill_tokens equals evaluating it once at the total:
    the byte predictor prices token-by-token teacher forcing (m cycles of
    1) and batched chunked prefill (⌈S/C⌉ cycles of ≤C) *identically*,
    which is exactly why the engine's measured-vs-predicted equality keeps
    holding bit-exactly when chunking turns on.
    """
    return predict_m2n_cycle_bytes(prefill_tokens, hidden, top_k,
                                   dtype_bytes=dtype_bytes,
                                   gate_bytes=gate_bytes,
                                   idx_bytes=idx_bytes)
