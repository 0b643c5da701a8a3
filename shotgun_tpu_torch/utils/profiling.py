"""Per-phase timers of the port's CLI (``--profile``): the JAX package's
jax-free ``Profiler`` registry, shared so both CLIs report the same phase
names.  Device time is read with ``torch.profiler`` in
``shotgun_tpu_torch.tools.profile_align``, not here."""

from shotgun_tpu.utils.profiling import PROFILER, phase

__all__ = ["PROFILER", "phase"]
