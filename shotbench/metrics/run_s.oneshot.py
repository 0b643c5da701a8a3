"""The window's wall time over the whole dumpalign -g runs completed in
it (the window ends with its last run), read in the traced run."""


def read(run):
    if run.kind != "oneshot" or not run.requests:
        return None
    return run.window_s / len(run.requests)
