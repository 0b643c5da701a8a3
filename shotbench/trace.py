"""The traced window: a ``torch.profiler`` trace of it, read into device
busy time, kernel times by name and idle gaps by what the host was
doing.  A cell with an end-to-end metric from the device trace also has
its untraced window profiled, on the device alone (``read_device``)."""

from __future__ import annotations

import json
import os
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Tuple

from shotbench.yardstick import DEVICE_CATS, merge_intervals

#: the harness's span around the traced window
WINDOW_SPAN = "shotbench.window"
#: host events that can say what the host was doing
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime")
TOP = 10


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_busy_s: float                 # the kernels' alone, without copies or memsets
    kernels: Dict[str, List[float]]      # device event name -> seconds of each
    idle_by_host: Dict[str, float]       # host activity -> idle device seconds

    def kernel_seconds(self, fragment: str) -> List[float]:
        """Seconds of each device event whose name holds ``fragment``."""
        return [s for name, times in self.kernels.items() if fragment in name
                for s in times]

    def breakdown(self) -> dict:
        ops = sorted(((n, sum(t)) for n, t in self.kernels.items()), key=lambda x: -x[1])
        gaps = sorted(self.idle_by_host.items(), key=lambda x: -x[1])
        return {"device_ops": [[n[:120], s] for n, s in ops[:TOP]],
                "idle_gaps": [[n[:120], s] for n, s in gaps[:TOP]]}


def profiler(cuda: bool, host: bool = True):
    """A profile of the host's and the device's events, or of the
    device's alone (``host`` False: no host op is recorded)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] if host else []
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _events(prof, path: str) -> List[dict]:
    """The complete events of ``prof``'s Chrome trace, written to ``path``
    and removed after."""
    prof.export_chrome_trace(path)
    try:
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.remove(path)
    return [e for e in events if e.get("ph") == "X"]


def _busy_us(device: List[dict], w0: float, w1: float) -> float:
    """Microseconds of ``[w0, w1]`` in which one of ``device`` ran."""
    busy = merge_intervals((max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in device)
    return sum(b - a for a, b in busy)


def read_device(prof, path: str, window_s: float) -> Trace:
    """The ``Trace`` of a profile of the device alone around a window of
    ``window_s`` seconds: every device event in it, no idle gaps."""
    device = [e for e in _events(prof, path) if e.get("cat") in DEVICE_CATS]
    kernels: Dict[str, List[float]] = defaultdict(list)
    for e in device:
        kernels[e["name"]].append(e["dur"] / 1e6)
    inf = float("inf")
    return Trace(window_s=window_s, busy_s=_busy_us(device, -inf, inf) / 1e6,
                 kernel_busy_s=_busy_us([e for e in device if e["cat"] == "kernel"],
                                        -inf, inf) / 1e6,
                 kernels=dict(kernels), idle_by_host={})


def _innermost(host: List[Tuple[float, float, str]], points: List[float]) -> List[str]:
    """For each of the ascending ``points``, the name of the innermost
    host event (``(start, end, name)``, properly nested) that holds it."""
    out: List[str] = []
    stack: List[Tuple[float, float, str]] = []
    i = 0
    for x in points:
        while i < len(host) and host[i][0] <= x:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < x:
            stack.pop()
        out.append(stack[-1][2] if stack else "outside every host event")
    return out


def read_trace(prof, path: str) -> Trace:
    """The ``Trace`` of the window span in ``prof``'s Chrome trace, written
    to ``path`` and removed after."""
    spans = _events(prof, path)
    win = max((e for e in spans if e.get("name") == WINDOW_SPAN), key=lambda e: e["dur"])
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    device = [e for e in spans if e.get("cat") in DEVICE_CATS
              and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    kernels: Dict[str, List[float]] = defaultdict(list)
    for e in device:
        kernels[e["name"]].append(e["dur"] / 1e6)
    busy = merge_intervals((max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in device)
    busy_us = sum(b - a for a, b in busy)
    kernel_us = _busy_us([e for e in device if e["cat"] == "kernel"], w0, w1)
    gaps, cur = [], w0
    for a, b in busy:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if cur < w1:
        gaps.append((cur, w1))
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in spans
                  if e.get("cat") in HOST_CATS and e.get("tid") == win.get("tid")
                  and e.get("pid") == win.get("pid"))
    mids = [(a + b) / 2 for a, b in gaps]
    idle: Dict[str, float] = defaultdict(float)
    for (a, b), name in zip(gaps, _innermost(host, mids)):
        idle[name] += (b - a) / 1e6
    return Trace(window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6,
                 kernel_busy_s=kernel_us / 1e6, kernels=dict(kernels),
                 idle_by_host=dict(idle))

