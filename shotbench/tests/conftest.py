"""Tiny cells for the benchmark's CPU tests: a copy of ``BENCHMARK.json``
and ``shotbench/`` under a temporary directory, with small
configurations, traffic files and cells added by files and entries
alone, as a later change adds them."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest
import torch

#: the suite runs in several workers; a few threads each keep them from
#: starving one another
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

#: the tiny cells: name -> (configuration file it copies, its changes,
#: traffic file it copies, its changes)
TINY = {
    "tiny.deep": ("cami2_marine", dict(genomes=4, species=4, genome_len=30_000),
                  "deep", dict(reads_per_sample=6000)),
    "tiny.shallow": ("cami2_strain", dict(genomes=8, species=2, strains_per_species=4,
                                          genome_len=20_000),
                     "shallow", dict(reads_per_sample=4000, sample_files=3)),
    "tiny.oneshot": ("cami2_strain", dict(genomes=8, species=2, strains_per_species=4,
                                          genome_len=20_000),
                     "oneshot", dict(reads_per_sample=4000)),
}


def make_copy(dest: str) -> str:
    """``dest`` holding BENCHMARK.json and shotbench/ with the tiny cells
    added; returns ``dest``."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dest)
    shutil.copytree(os.path.join(REPO, "shotbench"), os.path.join(dest, "shotbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(dest, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    configs = {c["name"]: c for c in bench["configs"]}
    for cell, (cfg_name, cfg_changes, traffic, tr_changes) in TINY.items():
        tag = cell.replace(".", "_")
        with open(os.path.join(REPO, configs[cfg_name]["file"])) as fh:
            cfg = dict(json.load(fh), **cfg_changes, name=f"{tag}_cfg")
        path = f"shotbench/configs/{tag}_cfg.json"
        with open(os.path.join(dest, path), "w") as fh:
            json.dump(cfg, fh)
        with open(os.path.join(REPO, "shotbench", "traffic", f"{traffic}.json")) as fh:
            tr = dict(json.load(fh), **tr_changes)
        with open(os.path.join(dest, "shotbench", "traffic", f"{tag}.json"), "w") as fh:
            json.dump(tr, fh)
        bench["configs"].append(dict(configs[cfg_name], name=f"{tag}_cfg", file=path))
        bench["workloads"].append(dict(name=cell, config=f"{tag}_cfg", traffic=tag,
                                       chips=1, why="a tiny cell of the CPU tests"))
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh, indent=1)
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> str:
    return make_copy(str(tmp_path_factory.mktemp("bench")))
