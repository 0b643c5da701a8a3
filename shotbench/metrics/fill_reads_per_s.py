"""Reads a second of the native FASTQ fill alone (``chunks_packed`` over
every sample file, nothing on the device), by the host clock."""


def read(run):
    if run.fill is None or run.fill[1] <= 0:
        return None
    return run.fill[0] / run.fill[1]
