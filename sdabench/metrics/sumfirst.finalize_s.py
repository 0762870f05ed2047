"""Host seconds of an aggregate's epilogue (``clerk_sums_from_limb_acc`` and
the reconstruction), after a synchronise, averaged over the window."""

UNIT, SOURCE, LAYER, MOVES = "s", "program_span", "host epilogue", "secure_sum_elems_per_s"


def read(run):
    s = run.host_s.get("finalize")
    return sum(s) / len(s) if s else None
