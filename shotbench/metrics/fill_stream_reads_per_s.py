"""Reads a second of the native FASTQ fill inside the stream: the reads
of the window's samples over the seconds of the program's phase span
``fill`` (the producer thread's chunk buffers and native fill calls)."""


def read(run):
    seconds, calls = run.spans.get("fill", (0.0, 0))
    reads = sum(r.reads for r in run.requests)
    if not calls or seconds <= 0 or not reads:
        return None
    return reads / seconds
