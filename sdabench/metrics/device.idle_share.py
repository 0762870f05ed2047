"""The share of the traced window in which no device op ran, from the
profiler's trace."""

UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "device", "secure_sum_elems_per_s"


def read(run):
    trace = run.trace
    if trace is None or trace.missing_records or trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
