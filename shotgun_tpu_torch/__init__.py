"""shotgun_tpu_torch: the PyTorch + CUDA port of ``shotgun_tpu``.

The JAX package ``shotgun_tpu`` stays the reference; this package mirrors
its layout module by module (``ops/encode.py``, ``ops/probe.py``,
``ops/probe_sort.py``, ``ops/probe_sort2.py``, ``index/device_build.py``,
``models/pipeline.py``, ``reference.py``, ``aligner.py``, ``cli.py``) and
is held against it by ``tests/test_torch_*.py``.

Ported slice: ``-t dumpalign`` at k <= 31, streamed from the native FASTQ
fill, by the JAX package's default routes: the sort-join probe or the
bucket-hash probe (4- and 16-slot tables), and the database built on the
device or on the host.  The three Pallas kernels of that path are
hand-written CUDA kernels for Hopper (``ops/kernels/csrc``); each has a
plain PyTorch version beside its wrapper, which runs only for tensors on
the CPU.

Import rules: ``torch`` and never ``jax``.  Of the JAX package only its
jax-free host modules are reused: ``constants``, ``errors``,
``io.{records,data_file,packing,native}``, ``index.build``,
``index.extsim`` and ``utils.{profiling,synth}``.
"""

__version__ = "0.1.0"
