"""Milliseconds of the program's phase span ``db_build_device`` a call, over the
traced window's runs."""


def read(run):
    seconds, calls = run.spans.get("db_build_device", (0.0, 0))
    return 1e3 * seconds / calls if calls else None
