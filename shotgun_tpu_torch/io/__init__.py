"""Input for the port: the FASTA/FASTQ readers (``records``,
``data_file``), the record packing (``packing``) and the native C++ parse,
fill and k-mer build library (``native``, built into ``build/host/``).

``native_available`` says whether the native library built.  Without it
the stream route is skipped and reads go through the much slower regex
parser, so a run that must take the stream route checks it first."""

from shotgun_tpu_torch.io import native as _native


def native_available() -> bool:
    """True when the native parse/fill library is built and loaded."""
    return _native.available()
