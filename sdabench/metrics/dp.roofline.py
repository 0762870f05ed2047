"""The DP wire's share of its roofline: the least time of the traced rounds'
float32 updates read once and noisy int32 values written once (8 bytes a
coordinate) over the device time of the ops launched inside the ``quantize``
and ``noise`` spans (``dp_clip_quantize``, ``dp_add_noise``), from the
profiler's trace."""

UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "distributed DP", "secure_sum_elems_per_s"
SPANS = ("quantize", "noise")


def read(run):
    trace = run.trace
    if trace is None or trace.missing_records:
        return None
    device = sum(trace.span_device_s.get(span, 0.0) for span in SPANS)
    least = sum(run.units[i].layer_least_s.get("dp", 0.0) for i in trace.units)
    return 100.0 * least / device if least and device else None
