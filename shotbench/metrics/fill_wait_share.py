"""Percent of the traced window the stream's consumer spent blocked on
its fill: the program's phase span ``fill_wait`` (main thread, around the
prefetch queue's ``get``) over the window's wall time."""


def read(run):
    seconds, calls = run.spans.get("fill_wait", (0.0, 0))
    if not calls or run.window_s <= 0:
        return None
    return 100.0 * seconds / run.window_s
