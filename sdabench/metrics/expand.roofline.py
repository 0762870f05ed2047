"""Seed expansion's share of its roofline: the least time of the ChaCha20
work that the traced rounds' masks and folds need (``least_time.chacha_s``)
over the device time of the ops launched inside the ``expand`` spans
(``expand_seeds_counts`` and ``combine_masks_device``: K2 and the
compaction around it), from the profiler's trace."""

UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "seed expansion", "secure_sum_elems_per_s"
SPAN = "expand"


def read(run):
    trace = run.trace
    if trace is None or trace.missing_records or not trace.span_device_s.get(SPAN):
        return None
    least = sum(run.units[i].layer_least_s.get(SPAN, 0.0) for i in trace.units)
    return 100.0 * least / trace.span_device_s[SPAN] if least else None
