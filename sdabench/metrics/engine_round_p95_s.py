"""The 95th percentile (nearest rank) of the wall time of every round in the
window: what a training loop waits for each round."""

import math

UNIT, SOURCE, LAYER, MOVES = "s", "host_clock", None, None


def read(run):
    walls = sorted(u.wall_s for u in run.units)
    if not walls:
        return None
    return walls[math.ceil(0.95 * len(walls)) - 1]
