"""A checkout root of the benchmark at a size the CPU tests can hold: the
repository's ``BENCHMARK.json`` and data files, with the configurations'
and mixes' sizes cut."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

SIZES = {
    "configs/paper-spd-16k.json": {"n": 256, "row_nnz": 4},
    "configs/hpcg-27pt-104.json": {"nx": 12, "ny": 8, "nz": 6},
    "traffic/solve-gs-k51.json": {"k": 3, "trace_units": 2},
    "traffic/solve-bgs128-k51.json": {"k": 3, "block": 16, "trace_units": 2},
    "traffic/sweep-bgs8-k1.json": {"block": 4},
}


def _edit(path: Path, changes: dict) -> None:
    data = json.loads(path.read_text())
    data.update(changes)
    path.write_text(json.dumps(data))


def make_root(tmp: Path) -> Path:
    """A copy of the benchmark's files under ``tmp`` at the cut sizes."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for part in ("configs", "traffic", "cells", "metrics", "generators"):
        shutil.copytree(ROOT / "bench" / part, tmp / "bench" / part)
    for rel, changes in SIZES.items():
        _edit(tmp / "bench" / rel, changes)
    return tmp
