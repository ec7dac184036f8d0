"""Find a cell's parts by the names in BENCHMARK.json.

A configuration is the file its entry names (``benchmark/configs/<name>.json``;
its scene generator is ``benchmark/scenes/<generator>.py``), a traffic mix
is ``benchmark/traffic/<name>.json`` and a per-layer metric is
``benchmark/metrics/<name>.py`` with a ``read(trace)`` function. Adding
any of them is adding files and entries: nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent  # the checkout


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def load_traffic(name: str, root: Path = ROOT) -> dict:
    return json.loads((root / "benchmark" / "traffic" / f"{name}.json").read_text())


def scene_generator(name: str, root: Path = ROOT):
    """``build(params, rng)`` of ``benchmark/scenes/<name>.py``."""
    return _load(root / "benchmark" / "scenes" / f"{name}.py", "benchmark_scene_").build


def metric_reader(name: str, root: Path = ROOT):
    """``read`` of ``benchmark/metrics/<name>.py`` (a name may hold dots)."""
    return _load(root / "benchmark" / "metrics" / f"{name}.py", "benchmark_metric_").read


def _load(path: Path, prefix: str):
    tag = prefix + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The metrics of ``kind`` ("end_to_end" or "per_layer") the cell reports."""
    return [m for m in bench[kind] if "workloads" not in m or cell in m["workloads"]]
