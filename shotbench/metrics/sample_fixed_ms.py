"""Milliseconds a sample of the program's per-sample phase spans: stream
open (the file read), table lookup, validation, the carry fetch (with the
drain of the sample's queued launches), the host merge and the summary,
over the calls of ``stream_align``.  Nothing unless every one of them
was recorded."""

FIXED = ("stream_open", "table_build", "validate", "carry_fetch", "host_merge", "summary")


def read(run):
    spans = [run.spans.get(name) for name in FIXED + ("stream_align",)]
    if any(s is None or not s[1] for s in spans):
        return None
    return 1e3 * sum(s[0] for s in spans[:-1]) / spans[-1][1]
