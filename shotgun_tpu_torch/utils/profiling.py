"""Per-phase wall-clock / throughput counters of the port's CLI
(``--profile``; the port's copy of ``shotgun_tpu/utils/profiling.py``,
with the same report format).

A process-global registry of phase timers (parse, build, table, align,
store, save, and the stream's fill, staging, launches and per-sample
steps) and counters (how the fill walked its chunks) surfaced by the
CLI's ``--profile`` flag.  While enabled, each
phase is also a ``torch.profiler.record_function`` span, so a
``torch.profiler`` trace shows it as a ``user_annotation`` on the clock
of the device's kernels.  Phases may run on several threads (the
stream's fill runs on its producer thread); a span never stays open
across a generator's ``yield``, so each thread's spans nest.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Iterator

from torch.profiler import record_function

__all__ = ["PROFILER", "PhaseStat", "Profiler", "parse_report", "phase"]


@dataclass
class PhaseStat:
    seconds: float = 0.0
    calls: int = 0
    items: int = 0  # unit count (reads, bases, ...), caller-defined
    counter: bool = False  # made by ``Profiler.count``: calls and items, no time


class Profiler:
    def __init__(self) -> None:
        self.enabled = False
        self.stats: "OrderedDict[str, PhaseStat]" = OrderedDict()
        self._lock = threading.Lock()

    def enable(self) -> None:
        self.enabled = True

    @contextlib.contextmanager
    def phase(self, name: str, items: int = 0) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            with record_function(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                st = self.stats.setdefault(name, PhaseStat())
                st.seconds += dt
                st.calls += 1
                st.items += items

    def count(self, name: str, items: int = 0) -> None:
        """One call of ``items`` into the counter ``name``: an entry of
        ``stats`` with no time and no span, printed without a time."""
        if not self.enabled:
            return
        with self._lock:
            st = self.stats.setdefault(name, PhaseStat(counter=True))
            st.calls += 1
            st.items += items

    def report(self, stream=None) -> None:
        if not self.enabled or not self.stats:
            return
        stream = stream or sys.stderr
        print("=== profile ===", file=stream)
        for name, st in self.stats.items():
            if st.counter:
                print(f"{name:20s} {'':13s}  x{st.calls}  {st.items:,} items",
                      file=stream)
                continue
            rate = ""
            if st.items and st.seconds > 0:
                rate = f"  {st.items / st.seconds:,.0f}/s"
            print(
                f"{name:20s} {st.seconds * 1e3:10.1f} ms  x{st.calls}{rate}",
                file=stream,
            )


def parse_report(text: str) -> dict:
    """{phase: seconds} of the ``Profiler.report`` in ``text`` (a CLI
    run's stderr with ``--profile``)."""
    stages = {}
    for line in text.split("=== profile ===", 1)[1].splitlines():
        fields = line.split()
        if len(fields) >= 3 and fields[2] == "ms":
            stages[fields[0]] = float(fields[1]) / 1e3
    return stages


#: process-global profiler used by the CLI
PROFILER = Profiler()
phase = PROFILER.phase
