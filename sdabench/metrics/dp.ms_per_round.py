"""Milliseconds of a round's DP wire (``dp_clip_quantize`` and
``dp_add_noise``: the row clip, the quantization and the parties' noise):
CUDA events around every chunk's two calls, totalled over the window's
rounds, over their count."""

UNIT, SOURCE, LAYER, MOVES = "ms", "program_span", "distributed DP", "secure_sum_elems_per_s"


def read(run):
    ms = run.events_ms.get("dp")
    return sum(ms) / len(run.units) if ms and run.units else None
