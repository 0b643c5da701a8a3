"""Input for the port: the JAX package's jax-free readers
(``shotgun_tpu.io``), which the CLI and the aligner import directly.

``native_available`` says whether the native C++ FASTA/FASTQ library
built.  Without it the stream route is skipped and reads go through the
much slower regex parser, so a run that must take the stream route
checks it first."""

from shotgun_tpu.io import native as _native


def native_available() -> bool:
    """True when the native parse/fill library is built and loaded."""
    return _native.available()
