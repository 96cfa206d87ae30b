"""``step_mfu`` on a cell held past capacity, read as that reader reads it:
the whole step's share of the card's bf16 peak, which there moves with the
tokens completed per second."""

from pathlib import Path

from afdbench import harness

LAYER = "whole step"
UNIT = "%"
MOVES = "tokens_per_s"

read = harness.load_reader(Path(__file__).resolve().parents[2],
                            "step_mfu").read
