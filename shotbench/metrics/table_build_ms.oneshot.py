"""Milliseconds of the program's phase span ``table_build`` a call, over the
traced window's runs."""


def read(run):
    seconds, calls = run.spans.get("table_build", (0.0, 0))
    return 1e3 * seconds / calls if calls else None
