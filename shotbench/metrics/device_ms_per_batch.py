"""Device busy milliseconds (the union of kernel, copy and memset
intervals in the trace) over the batches of the traced window."""


def read(run):
    batches = sum(r.batches for r in run.requests)
    if run.trace is None or run.trace.busy_s <= 0 or not batches:
        return None
    return 1e3 * run.trace.busy_s / batches
