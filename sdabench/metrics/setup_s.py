"""Set-up time: from the start of the run to the start of the window (the
imports, the pools drawn on the card, the port's plan, its kernels built or
loaded, the warm-up of the cell's own shapes)."""

UNIT, SOURCE, LAYER, MOVES = "s", "host_clock", None, None


def read(run):
    return run.setup_s
