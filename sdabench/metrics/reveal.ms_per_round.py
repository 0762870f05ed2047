"""Milliseconds of a round's reveal and apply (``limb_recombine``,
``engine.reconstruct``, the fold's subtraction, ``dequantize_mean``,
``fedavg_apply``): CUDA events around it, totalled over the window's
rounds, over their count."""

UNIT, SOURCE, LAYER, MOVES = "ms", "program_span", "reveal and apply", "engine_round_p95_s"


def read(run):
    ms = run.events_ms.get("reveal")
    return sum(ms) / len(ms) if ms else None
