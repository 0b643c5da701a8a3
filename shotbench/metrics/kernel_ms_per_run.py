"""Kernel milliseconds (the union of the kernels' intervals in the
device's trace of the window; copies and memsets, which the host paces
from pageable memory, left out) over the whole dumpalign -g runs completed
in the window."""


def read(run):
    if run.kind != "oneshot" or run.trace is None or run.trace.kernel_busy_s <= 0 \
            or not run.requests:
        return None
    return 1e3 * run.trace.kernel_busy_s / len(run.requests)
