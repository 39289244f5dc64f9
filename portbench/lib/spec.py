"""The benchmark's files, found by the names ``BENCHMARK.json`` gives.

Under ``portbench/``: ``configs/<config>.json`` (a deployment: its mesh,
the tool's arguments, the settings it is served with, and the driver and
reference that go with it), ``traffic/<traffic>.json`` (the parameters of
a mix, read by :mod:`portbench.lib.traffic`), ``workloads/<cell>.json``
(what one cell adds: the correctness limits, the sample it checks, how
many requests a traced run traces), ``metrics/<metric>.py`` (one reader a
metric, end-to-end or per layer) and ``drivers/<driver>.py`` (how a
request reaches the tool and how its answer is judged).  A cell, a mix, a
configuration or a metric comes in as new files and entries; no file that
is there needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass
from typing import Dict, List

PACKAGE = "portbench"


@dataclass
class Cell:
    name: str
    config: Dict
    traffic: Dict
    workload: Dict
    chips: int
    end_to_end: List[Dict]
    per_layer: List[Dict]


def read_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """Import the file at ``path`` under ``name`` (names here may hold '-'
    and '.', so not by the import system's search)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Benchmark:
    """``BENCHMARK.json`` at ``root`` and the files it names."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.spec = read_json(os.path.join(self.root, "BENCHMARK.json"))
        self.base = os.path.join(self.root, PACKAGE)

    def path(self, kind: str, name: str, ext: str) -> str:
        return os.path.join(self.base, kind, name + ext)

    def _reports(self, metric: Dict, cell: str) -> bool:
        return cell in metric.get("workloads", [cell])

    def cell(self, name: str) -> Cell:
        entry = next((w for w in self.spec["workloads"]
                      if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        config = read_json(self.path("configs", entry["config"], ".json"))
        config.setdefault("name", entry["config"])
        return Cell(
            name=name, config=config,
            traffic=read_json(self.path("traffic", entry["traffic"],
                                        ".json")),
            workload=read_json(self.path("workloads", name, ".json")),
            chips=int(entry["chips"]),
            end_to_end=[m for m in self.spec["end_to_end"]
                        if self._reports(m, name)],
            per_layer=[m for m in self.spec["per_layer"]
                       if self._reports(m, name)])

    def metric_reader(self, name: str):
        return load_module(self.path("metrics", name, ".py"),
                           f"{PACKAGE}_metric_{name}")

    def driver(self, name: str):
        return load_module(self.path("drivers", name, ".py"),
                           f"{PACKAGE}_driver_{name}")
