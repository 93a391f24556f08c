"""Find a cell's pieces by name: ``BENCHMARK.json`` names the cell's
configuration and traffic mix; the configuration file names its family,
whose plain reference is ``benchmark/reference/<family>.py`` and whose
counts are ``benchmark/counts/<family>.py``; the traffic file is
``benchmark/traffic/<traffic>.json``, whose ``kind`` names the code that
drives it, ``benchmark/kinds/<kind>.py``; the comparison's limits are
``benchmark/limits/<cell>.json`` and each metric's reader, end-to-end or
per-layer, ``benchmark/metrics/<metric>.py``. A new cell, configuration,
traffic mix, kind or metric is new files and entries; nothing here
changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
from typing import Dict, List, Optional

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict          # the configuration file
    traffic_name: str
    traffic: dict         # the traffic file
    limits: dict          # number compared -> its limit
    end_to_end: List[dict]
    per_layer: List[dict]
    root: str

    @property
    def family(self) -> str:
        return self.config["family"]

    @property
    def model(self) -> dict:
        return self.config["model"]

    def reference(self):
        """The family's plain reference module."""
        return importlib.import_module(f"benchmark.reference.{self.family}")

    def counts(self, name: Optional[str] = None):
        """``benchmark/counts/<name>.py`` (default: the family's)."""
        return load_file(os.path.join(self.root, "benchmark", "counts",
                                      f"{name or self.family}.py"))


def load_file(path: str):
    """A module from its file, whatever its name holds (metric names have
    dots)."""
    name = "bench_" + os.path.relpath(path, ROOT).replace(os.sep, "_") \
        .replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: every cell, or those its
    ``workloads`` lists."""
    return cell in metric.get("workloads", (cell,))


def load(workload: str, root: str = ROOT,
         overrides: Optional[dict] = None) -> Cell:
    """The cell ``workload`` of ``root``'s ``BENCHMARK.json``. ``overrides``
    ({"model": {...}, "traffic": {...}}) change sizes for the CPU tests."""
    spec = _json(os.path.join(root, "BENCHMARK.json"))
    found = [w for w in spec["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = found[0]
    bench = os.path.join(root, "benchmark")
    cfg_entry = [c for c in spec["configs"] if c["name"] == w["config"]][0]
    config = _json(os.path.join(root, cfg_entry["file"]))
    traffic = _json(os.path.join(bench, "traffic", f"{w['traffic']}.json"))
    limits = _json(os.path.join(bench, "limits", f"{workload}.json"))
    overrides = overrides or {}
    config["model"].update(overrides.get("model", {}))
    traffic.update(overrides.get("traffic", {}))
    e2e = [m for m in spec["end_to_end"] if _reports(m, workload)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if _reports(m, workload) and m["moves"] in names]
    return Cell(workload, int(w["chips"]), w["config"], config,
                w["traffic"], traffic, limits, e2e, per_layer, root)


def kind(cell: Cell):
    """The module that runs ``cell``'s traffic: its ``run(cell, seed,
    seconds, trace, device, t_start, fault=None)`` returns the run's
    record."""
    return load_file(os.path.join(cell.root, "benchmark", "kinds",
                                  f"{cell.traffic['kind']}.py"))


def readers(cell: Cell, trace: bool = True) -> Dict[str, object]:
    """The readers of ``cell``'s per-layer metrics (``trace``) or its
    end-to-end ones, by name."""
    return {m["name"]: load_file(os.path.join(
        cell.root, "benchmark", "metrics", f"{m['name']}.py"))
        for m in (cell.per_layer if trace else cell.end_to_end)}
