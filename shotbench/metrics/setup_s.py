"""Seconds from process start to the first timed request: inputs, the
program's set-up, kernel builds and the warm-up request."""


def read(run):
    return run.setup_s
