"""Fixtures of the benchmark's own tests: a small copy of the benchmark's
data (configurations at 128x72 on the kernel branch, short traffic) in a
temporary checkout, and a helper that runs one cell of it on the CPU.

Run them from the repository root: ``python -m pytest benchmark/tests -q``.
Tests marked ``cuda`` need the card and skip here.
"""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

DATA = ("configs", "traffic", "metrics", "scenes")


# the dragon's configuration and cells: data files of the benchmark that
# BENCHMARK.json leaves out while the renderer draws sliver pixels past
# a triangle's box (PERF.md, open questions); the tests still run them
KEPT_CONFIGS = [{"name": "dragon_attenuation", "source": "-",
                 "file": "benchmark/configs/dragon_attenuation.json",
                 "reduced": ["triangles", "base_scene"], "why": "-"}]
KEPT_CELLS = [{"name": "dragon.orbit", "config": "dragon_attenuation", "traffic": "orbit",
               "chips": 1, "why": "-"},
              {"name": "dragon.rt_orbit", "config": "dragon_attenuation",
               "traffic": "rt_orbit", "chips": 1, "why": "-"}]


def make_small_root(dst: Path) -> Path:
    """A checkout holding BENCHMARK.json (with the kept dragon cells) and
    the benchmark's data files, shrunk: 128x72 frames on the kernel
    branch, a 24 x 48 blob, one warm-up frame, and the window's first
    frame checked."""
    (dst / "benchmark").mkdir(parents=True)
    for d in DATA:
        shutil.copytree(ROOT / "benchmark" / d, dst / "benchmark" / d)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = {c["name"] for c in bench["configs"]} | {w["name"] for w in bench["workloads"]}
    bench["configs"] += [c for c in KEPT_CONFIGS if c["name"] not in names]
    bench["workloads"] += [w for w in KEPT_CELLS if w["name"] not in names]
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    for f in (dst / "benchmark" / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c["render"].update(width=128, height=72, use_pallas_raster=True)
        if c["generator"] == "dragon":
            c["scene"].update(stacks=24, sectors=48)
        f.write_text(json.dumps(c))
    for f in (dst / "benchmark" / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t.update(warmup_frames=1, checked_frames=1, check_within_frames=1)
        f.write_text(json.dumps(t))
    return dst


@pytest.fixture(scope="session")
def small_root(tmp_path_factory) -> Path:
    return make_small_root(tmp_path_factory.mktemp("bench") / "checkout")


def run_small(root: Path, cell: str, seed: int, traced: bool = False,
              render_hook=None) -> dict:
    """One run of ``cell`` of the checkout at ``root`` on the CPU. The
    window is as short as it gets: one frame (several when traced, which
    profiles a stretch of frames), the first, which is the one checked."""
    import torch

    from benchmark.core import cell as cell_mod
    from benchmark.core import registry

    torch.set_num_threads(4)
    bench = registry.load_benchmark(root)
    return cell_mod.run(bench, cell, seed, 0.001, traced, torch.device("cpu"), time.time(),
                        root=root, render_hook=render_hook)
