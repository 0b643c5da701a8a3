"""Milliseconds of the program's phase span ``db_host_prep`` a call (the
device build's host packing of the genome codes), over the traced
window's runs."""


def read(run):
    seconds, calls = run.spans.get("db_host_prep", (0.0, 0))
    return 1e3 * seconds / calls if calls else None
