"""shotgun_tpu_torch: the PyTorch + CUDA port of ``shotgun_tpu``.

The JAX package ``shotgun_tpu`` stays the reference; this package mirrors
its layout module by module (``ops/encode.py``, ``ops/probe.py``,
``ops/probe_sort.py``, ``ops/probe_sort2.py``, ``index/device_build.py``,
``models/pipeline.py``, ``reference.py``, ``aligner.py``, ``cli.py``) and
is held against it by ``tests/test_torch_*.py``.

It runs the four CLI tasks (``reference``, ``dumpref``, ``align``,
``dumpalign``) at any k >= 1 by the JAX package's routes: the sort-join
probe, the bucket-hash probe (4- and 16-slot tables) and, at k > 31, the
sort join of multi-word keys; the database built on the device or on the
host.  The single-read API (``Read``, ``PseudoAlignment.add_read*``) runs
on the host.  ``parallel/`` shards reads over a mesh of devices and
processes (``torch.distributed``), and the sorted table over a table
axis, with exact integer merges.  The three Pallas kernels of the JAX package are two
hand-written CUDA kernels for Hopper (``ops/kernels/csrc``); each has a
plain PyTorch version beside its wrapper, which runs only for tensors on
the CPU.

Import rules: ``torch`` and never ``jax``, and nothing of ``shotgun_tpu``:
the host modules are the port's own copies (``constants``, ``errors``,
``io``, ``index/build.py``, ``utils``).
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy imports keep `import shotgun_tpu_torch` light (no torch import)
    if name in ("FASTAFile", "FASTAQFile", "InvalidExtensionError",
                "NoRecordsInDataFile"):
        from shotgun_tpu_torch.io import data_file
        return getattr(data_file, name)
    if name in ("KmerReference", "KDBFormatError", "reverse_complement",
                "extract_kmers_from_genome"):
        from shotgun_tpu_torch import reference
        return getattr(reference, name)
    if name in ("PseudoAlignment", "Read", "ReadMappingType", "KmerSpecifity",
                "ReadKmer", "ReadMapping", "AddingExistingRead",
                "NotValidatingUniqueMapping"):
        from shotgun_tpu_torch import aligner
        return getattr(aligner, name)
    raise AttributeError(f"module 'shotgun_tpu_torch' has no attribute {name!r}")
