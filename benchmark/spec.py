"""Finds what ``BENCHMARK.json`` names: a cell's configuration, traffic,
limits, runner and per-layer readers, each a file of its own under the
benchmark's directory, by its name.  Adding a cell, a configuration, a
traffic mix or a metric adds files; no file here lists them."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """``BENCHMARK.json`` under ``root`` and the files of the benchmark's
    directory ``root/benchmark``."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.dir = os.path.join(root, "benchmark")
        self.bench = _json(os.path.join(root, "BENCHMARK.json"))

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return _json(os.path.join(self.dir, "configs", f"{name}.json"))

    def traffic(self, name: str) -> dict:
        return _json(os.path.join(self.dir, "traffic", f"{name}.json"))

    def cell(self, name: str) -> dict:
        return _json(os.path.join(self.dir, "cells", f"{name}.json"))

    def _metrics(self, key: str, cell: str) -> list:
        return [m for m in self.bench[key] if "workloads" not in m or cell in m["workloads"]]

    def end_to_end(self, cell: str) -> list:
        """The end-to-end metrics the cell reports: those that list it, and
        those that list no cells."""
        return self._metrics("end_to_end", cell)

    def per_layer(self, cell: str) -> list:
        return self._metrics("per_layer", cell)

    def reader(self, metric: str):
        """``read(ctx)`` of ``metrics/<metric>.py``: the metric's value, or
        None when the run gave it nothing to read."""
        path = os.path.join(self.dir, "metrics", f"{metric}.py")
        module_spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
        module = importlib.util.module_from_spec(module_spec)
        module_spec.loader.exec_module(module)
        return module.read


@dataclass
class Run:
    """One run of one cell, as a runner gets it."""

    workload: dict        # the cell's entry of BENCHMARK.json
    config: dict
    traffic: dict
    limits: dict          # the cell's limits, by the name of each number compared
    seed: int
    seconds: float
    trace: bool
    started: float        # time.monotonic() at the process's start
    device: str = "cuda"  # "cpu" in the tests, which skip the look for a card
    patch: str = ""       # "module:function" applied before the program runs (tests only)
    root: str = ROOT      # the checkout the program is imported from

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def kind(name: str):
    """The runner ``kinds/<name>.py`` that a traffic file's ``kind`` names."""
    return importlib.import_module(f"benchmark.kinds.{name}")
