"""Device milliseconds of one chunk's call into the sum-first reduction and
its randomness draws (``value_limb_sums_chunk_pair``): CUDA events around
every chunk's call, totalled over the window's chunks, over their count."""

UNIT, SOURCE, LAYER, MOVES = "ms", "program_span", "sum-first reduction", "secure_sum_elems_per_s"


def read(run):
    ms = run.events_ms.get("chunk")
    return sum(ms) / len(ms) if ms else None
