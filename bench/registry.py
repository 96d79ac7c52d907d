"""Find a cell's files by the names ``BENCHMARK.json`` gives.

``root`` is the checkout's root: ``BENCHMARK.json`` lies there and the
cells' files under ``root/bench``.  Generators and metric readers are
loaded from their files by path, so a later change adds one by adding a
file and never edits one that is there.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parents[1]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(Path(root) / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> dict:
    """The ``workloads`` entry of cell ``name``."""
    for entry in benchmark(root)["workloads"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no workload {name!r} in {Path(root) / 'BENCHMARK.json'}")


def config(name: str, root: Path = ROOT) -> dict:
    return _json(Path(root) / "bench" / "configs" / f"{name}.json")


def traffic(name: str, root: Path = ROOT) -> dict:
    return _json(Path(root) / "bench" / "traffic" / f"{name}.json")


def cell_data(name: str, root: Path = ROOT) -> dict:
    return _json(Path(root) / "bench" / "cells" / f"{name}.json")


def _module(path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        "bench_plugin_" + path.stem.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def generator(name: str, root: Path = ROOT) -> ModuleType:
    """``generators/<name>.py``: ``generate(config, device) -> Problem``."""
    return _module(Path(root) / "bench" / "generators" / f"{name}.py")


def reader(metric: str, root: Path = ROOT) -> ModuleType:
    """The reader of ``metric``: ``metrics/<metric>.py``, else the file of
    its stem (the name without its last dotted part), and so on."""
    parts = metric.split(".")
    for end in range(len(parts), 0, -1):
        path = Path(root) / "bench" / "metrics" / (".".join(parts[:end]) + ".py")
        if path.exists():
            return _module(path)
    raise FileNotFoundError(f"no reader for metric {metric!r} under "
                            f"{Path(root) / 'bench' / 'metrics'}")


def cell_metrics(name: str, group: str, root: Path = ROOT) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics cell ``name`` reports.
    A metric with a ``workloads`` key is reported in the cells it lists; a
    per-layer metric without one in every cell that reports the
    end-to-end metric it moves; an end-to-end metric without one in every
    cell."""
    bm = benchmark(root)
    e2e = [m for m in bm["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    if group == "end_to_end":
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bm["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]
