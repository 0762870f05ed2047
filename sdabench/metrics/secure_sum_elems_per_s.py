"""Participants x dims aggregated and revealed in the window's whole units,
over the window's time on the host clock."""

UNIT, SOURCE, LAYER, MOVES = "elems/s", "host_clock", None, None


def read(run):
    if not run.units or run.window_s <= 0:
        return None
    return sum(u.elems for u in run.units) / run.window_s
