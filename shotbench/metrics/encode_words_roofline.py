"""Kernel H3 ``encode_words``: the least time to move the bytes of every
launch in the traced window at the published HBM rate, over the trace's
time of its launches, in percent.  Nothing when the trace holds another
number of launches than the window made."""

from shotbench.yardstick import bound_s


def read(run):
    want = run.launches.get("encode_words")
    if run.trace is None or not want:
        return None
    times = run.trace.kernel_seconds("encode_words_kernel")
    if len(times) != len(want) or sum(times) <= 0:
        return None
    return 100.0 * bound_s(sum(want)) / sum(times)
