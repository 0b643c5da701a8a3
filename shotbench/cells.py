"""A cell of ``BENCHMARK.json``, found by name: its configuration file,
its traffic file (``traffic/<traffic>.json`` beside this module) and the
readers of its metrics (``metrics/<metric>.py``).  Nothing here knows a
cell, a configuration or a metric by name, so a later change adds one
with files and entries alone."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

#: the benchmark's folder name, under the checkout's root
BENCH_DIR = os.path.basename(os.path.dirname(os.path.abspath(__file__)))


@dataclass
class Metric:
    name: str
    unit: str
    read: Callable[[object], Optional[float]]
    source: str = "host_clock"     # where the number comes from, as BENCHMARK.json says


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)
    #: the configuration's ``{"data": d, "table": t}``, a process a card;
    #: None: one process on one card
    mesh: Optional[Dict[str, int]] = None


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _reader(root: str, name: str) -> Callable[[object], Optional[float]]:
    path = os.path.join(root, BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"shotbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_cell(root: str, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; its end-to-end
    metrics are those listed for it (or for every cell), its per-layer
    metrics those listed for it or, without a list, those that move one
    of its end-to-end metrics."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: {sorted(cells)})")
    w = cells[name]
    configs: Dict[str, dict] = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(root, BENCH_DIR, "traffic", f"{w['traffic']}.json"))

    def applies(metric: dict) -> bool:
        return name in metric.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    mesh = config.get("mesh")
    if mesh is not None and (mesh["data"] * mesh["table"] != w["chips"] or w["chips"] < 2):
        raise ValueError(f"cell {name!r}: its configuration's mesh {mesh} does not "
                         f"cover its {w['chips']} chips, or there is one")
    return Cell(name=name, chips=w["chips"], config=config, traffic=traffic, mesh=mesh,
                end_to_end=[Metric(m["name"], m["unit"], _reader(root, m["name"]),
                                   m["source"]) for m in e2e],
                per_layer=[Metric(m["name"], m["unit"], _reader(root, m["name"]),
                                  m["source"]) for m in layer])
