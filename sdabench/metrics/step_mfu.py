"""The whole step's share of the card's peak: the least time of each
aggregate or round (``least_time``: the handed inputs read once, or the
ChaCha20 work where that is larger) over its wall time on the host clock,
summed over the window's units that the profiler did not trace."""

UNIT, SOURCE, LAYER, MOVES = "%", "host_clock", "whole step", "secure_sum_elems_per_s"


def read(run):
    traced = set(run.trace.units) if run.trace is not None else set()
    units = [u for i, u in enumerate(run.units) if i not in traced] or run.units
    wall = sum(u.wall_s for u in units)
    if wall <= 0:
        return None
    return 100.0 * sum(u.least_s for u in units) / wall
