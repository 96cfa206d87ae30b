"""``runtime.prefill_chunk_ms`` on a cell held past capacity, read as that
reader reads it: the mean host wall of ``AFDRuntime.prefill`` (one prompt
chunk), sync-ended. There every tick runs one, so the chunk is most of the
tick that sets the tokens completed per second."""

from pathlib import Path

from afdbench import harness

LAYER = "parallel/afd"
UNIT = "ms"
MOVES = "tokens_per_s"

read = harness.load_reader(Path(__file__).resolve().parents[2],
                            "runtime.prefill_chunk_ms").read
