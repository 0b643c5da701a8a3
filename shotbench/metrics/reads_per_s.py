"""Reads of the whole samples completed in the window over the window's
wall time (the window ends with its last sample)."""


def read(run):
    if run.kind != "resident" or run.window_s <= 0:
        return None
    return sum(r.reads for r in run.requests) / run.window_s
