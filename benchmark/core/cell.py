"""A cell as ``BENCHMARK.json`` names it, and what a driver runs it with.

``BENCHMARK.json``'s ``workloads`` entry gives the cell's configuration
(whose ``file`` holds its sizes) and ``benchmark/workloads/<cell>.json`` the
rest: the ``driver`` (a module of ``benchmark/drivers``), the engine's
``engine`` options, the ``traffic`` parameters (``core/traffic.py``), the
``trace`` slice and the ``check``'s sample and limit.  A per-layer metric
``<name>`` is read by ``benchmark/metrics/<name>.py`` (:func:`reader`).
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional


@dataclass
class Cell:
    name: str
    entry: Dict  # the BENCHMARK.json workloads entry
    cfg: Dict  # the configuration file
    wl: Dict  # benchmark/workloads/<name>.json
    end_to_end: List[Dict]  # the end-to-end metrics this cell reports
    per_layer: List[Dict]  # the per-layer metrics this cell reports
    root: Path  # the checkout

    def reader(self, metric: str):
        return reader(self.root, metric)


def _applies(metric: Dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", None) is None or metric["moves"] in e2e_names


def load(root: Path, name: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cfg = json.loads((root / conf["file"]).read_text())
    wl = json.loads((root / "benchmark" / "workloads" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, ())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, names)]
    return Cell(name, entry, cfg, wl, e2e, per_layer, root)


def reader(root: Path, metric: str):
    """The module ``benchmark/metrics/<metric>.py``, loaded by its path since a
    name may hold dots (``mfu.chat``): its ``read(records)``, and ``LAYER``,
    ``UNIT`` and ``MOVES`` as ``BENCHMARK.json`` gives them."""
    name = f"benchmark.metrics.{metric}"
    if name not in sys.modules:
        path = root / "benchmark" / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


@dataclass
class Context:
    """What a driver gets: the cell, the run's seed and window length, the
    device, the tracer of a ``--trace 1`` run, the process's start time."""

    cell: Cell
    seed: int
    seconds: float
    device: object
    tracer: Optional[object]
    t_process: float

    @property
    def cfg(self) -> Dict:
        return self.cell.cfg

    @property
    def wl(self) -> Dict:
        return self.cell.wl
