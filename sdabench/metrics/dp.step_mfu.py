"""The whole DP round's share of the card's peak, read as ``step_mfu`` reads
it for the other cells."""

from pathlib import Path

from sdabench import catalog

UNIT, SOURCE, LAYER, MOVES = "%", "host_clock", "whole step", "secure_sum_elems_per_s"
read = catalog.metric("step_mfu", Path(__file__).resolve().parents[2]).read
