"""Milliseconds of the program's phase span ``stage`` a call: a batch's
three host arrays pinned and their copies to the device enqueued."""


def read(run):
    seconds, calls = run.spans.get("stage", (0.0, 0))
    return 1e3 * seconds / calls if calls else None
