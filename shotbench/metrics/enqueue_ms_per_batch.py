"""Milliseconds of the program's phase span ``enqueue`` a call: the host's
launch work for a batch's alignment and its fold into the carry."""


def read(run):
    seconds, calls = run.spans.get("enqueue", (0.0, 0))
    return 1e3 * seconds / calls if calls else None
