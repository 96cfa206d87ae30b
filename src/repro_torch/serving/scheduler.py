"""Serving policies of the port. ``ChunkedPrefillPolicy`` is a copy of
``repro.serving.scheduler.ChunkedPrefillPolicy``; the SLO scheduler waits
for the fleet/policy slice.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChunkedPrefillPolicy:
    """Chunked-prefill interleaving schedule: admitted prompts prefill
    ``chunk`` tokens at a time, and each engine tick runs at most
    ``max_chunks_per_tick`` chunks alongside the 3BO decode rotation.
    Decode TPOT stays bounded by the tick budget while TTFT drops from
    O(prompt) ticks (token-by-token teacher forcing) to O(prompt/chunk).
    FIFO across prefilling requests keeps the schedule deterministic.
    """
    chunk: int
    max_chunks_per_tick: int = 1

    def __post_init__(self) -> None:
        if self.chunk < 1:
            raise ValueError(f"chunk must be ≥ 1, got {self.chunk}")
        if self.max_chunks_per_tick < 1:
            raise ValueError("max_chunks_per_tick must be ≥ 1")

    def next_chunk(self, remaining: int) -> int:
        """Tokens to prefill next for a prompt with ``remaining`` left."""
        return min(self.chunk, remaining)
