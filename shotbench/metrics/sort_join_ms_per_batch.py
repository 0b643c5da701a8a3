"""Milliseconds a batch of the program's device phase ``sort_join_device``:
the sort join of the batch's windows against the table.  Its seconds
come from a pair of CUDA events around the join on the stream, so they
time the stream between the two markers, and any idle time inside the
join counts.  Nothing when the program has no such phase."""


def read(run):
    seconds, calls = run.spans.get("sort_join_device", (0.0, 0))
    return 1e3 * seconds / calls if calls else None
