"""Per-phase wall-clock / throughput counters of the port's CLI
(``--profile``; the port's copy of ``shotgun_tpu/utils/profiling.py``,
with the same phase names and report format).

A process-global registry of phase timers (parse, build, table, align,
store, save) surfaced by the CLI's ``--profile`` flag.  Device time is
read with ``torch.profiler`` in ``shotgun_tpu_torch.tools.profile_align``,
not here.
"""

from __future__ import annotations

import contextlib
import sys
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Iterator

__all__ = ["PROFILER", "PhaseStat", "Profiler", "phase"]


@dataclass
class PhaseStat:
    seconds: float = 0.0
    calls: int = 0
    items: int = 0  # unit count (reads, bases, ...), caller-defined


class Profiler:
    def __init__(self) -> None:
        self.enabled = False
        self.stats: "OrderedDict[str, PhaseStat]" = OrderedDict()

    def enable(self) -> None:
        self.enabled = True

    @contextlib.contextmanager
    def phase(self, name: str, items: int = 0) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            st = self.stats.setdefault(name, PhaseStat())
            st.seconds += dt
            st.calls += 1
            st.items += items

    def report(self, stream=None) -> None:
        if not self.enabled or not self.stats:
            return
        stream = stream or sys.stderr
        print("=== profile ===", file=stream)
        for name, st in self.stats.items():
            rate = ""
            if st.items and st.seconds > 0:
                rate = f"  {st.items / st.seconds:,.0f}/s"
            print(
                f"{name:20s} {st.seconds * 1e3:10.1f} ms  x{st.calls}{rate}",
                file=stream,
            )


#: process-global profiler used by the CLI
PROFILER = Profiler()
phase = PROFILER.phase
