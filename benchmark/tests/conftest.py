"""A checkout copy with tiny cells added as new files (``tiny_root``).

Run on the CPU with ``python -m pytest benchmark/tests -q`` from the repo's
root; the test marked ``gpu`` runs a real cell and needs the card."""

from __future__ import annotations

import hashlib
import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_CELLS = {
    "tiny-llama.chat": "tiny-llama",
    "tiny-moe.decode": "tiny-moe",
}


def tree_hashes(root: Path) -> dict:
    """sha256 of every file of the benchmark's folder and BENCHMARK.json."""
    files = [root / "BENCHMARK.json"] + sorted(
        p for p in (root / "benchmark").rglob("*") if p.is_file() and "__pycache__" not in p.parts)
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest() for p in files}


def add_tiny_cells(root: Path) -> None:
    """Add the tiny configurations and cells to the checkout at ``root`` as
    new files and new BENCHMARK.json entries only."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for cfg in sorted(set(TINY_CELLS.values())):
        dst = root / "benchmark" / "configs" / f"{cfg}.json"
        assert not dst.exists()
        shutil.copy(DATA / f"{cfg}.json", dst)
        bench["configs"].append(dict(name=cfg, source="a test size", file=str(dst.relative_to(root)),
                                     reduced=[], why="test"))
    for cell, cfg in TINY_CELLS.items():
        dst = root / "benchmark" / "workloads" / f"{cell}.json"
        assert not dst.exists()
        shutil.copy(DATA / f"{cell}.json", dst)
        bench["workloads"].append(dict(name=cell, config=cfg, traffic=cell.split(".")[1],
                                       chips=1, why="test"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            chat = any(c.endswith(".chat") for c in m["workloads"])
            m["workloads"] += [c for c in TINY_CELLS if c.endswith(".chat") == chat]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))


def copy_checkout(dst: Path) -> Path:
    shutil.copytree(REPO / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    root = copy_checkout(tmp_path_factory.mktemp("checkout"))
    add_tiny_cells(root)
    return root
