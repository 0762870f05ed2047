"""Share and combine's share of its roofline: the least time of the traced
rounds' masked int32 inputs read once and their clerk sums written once
(``least_time.share_s``) over the device time of the ops launched inside
the ``share`` spans (``share_combine_limb_streamed``: the randomness draws
and K1, and the accumulation), from the profiler's trace."""

UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "share and combine", "secure_sum_elems_per_s"
SPAN = "share"


def read(run):
    trace = run.trace
    if trace is None or trace.missing_records or not trace.span_device_s.get(SPAN):
        return None
    least = sum(run.units[i].layer_least_s.get(SPAN, 0.0) for i in trace.units)
    return 100.0 * least / trace.span_device_s[SPAN] if least else None
