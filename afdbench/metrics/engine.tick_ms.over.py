"""``engine.tick_ms`` on a cell held past capacity, read as that reader reads
it: the mean host wall of ``AFDServeEngine.tick``, sync-ended. There every
tick carries a prompt chunk and every slot is live, so the tick sets the
tokens completed per second."""

from pathlib import Path

from afdbench import harness

LAYER = "serving/afd_engine"
UNIT = "ms"
MOVES = "tokens_per_s"

read = harness.load_reader(Path(__file__).resolve().parents[2],
                            "engine.tick_ms").read
