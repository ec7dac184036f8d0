"""The glass dragon's cells on the CPU at 128x72 with a cut blob (24 x 48
stacks and sectors, in these tests only): the program's frames agree
with the plain reference within glass_dragon.json's limits under both
traffic mixes, the scene is the same whatever the seed, and the
bfloat16 light-math control and a stale frame do not agree."""

from __future__ import annotations

import json

import pytest
from conftest import make_small_root, run_small

CELLS = ["dragon.orbit", "dragon.rt_orbit"]


def make_dragon_root(dst):
    """conftest's small checkout, with glass_dragon's blob cut to 24 x 48."""
    root = make_small_root(dst)
    f = root / "benchmark" / "configs" / "glass_dragon.json"
    c = json.loads(f.read_text())
    c["scene"]["model"].update(stacks=24, sectors=48)
    f.write_text(json.dumps(c))
    return root


@pytest.fixture(scope="module")
def dragon_root(tmp_path_factory):
    return make_dragon_root(tmp_path_factory.mktemp("dragon") / "checkout")


@pytest.mark.parametrize("seed", [2**31 + 77, 4004])
@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_with_the_glass_dragon(dragon_root, workload, seed):
    cfg = json.loads((dragon_root / "BENCHMARK.json").read_text())
    assert {w["name"]: w["config"] for w in cfg["workloads"]}[workload] == "glass_dragon"
    r = run_small(dragon_root, workload, seed)
    assert r["correct"] is True, r["checks"]
    assert r["failed"] == 0


@pytest.mark.parametrize("workload", CELLS)
def test_bf16_control_fails_the_glass_dragon(tmp_path, workload):
    """The program's own bfloat16 light math in place of float32 comes out
    not correct, by more than three times the rmse limit."""
    root = make_dragon_root(tmp_path / "checkout")
    f = root / "benchmark" / "configs" / "glass_dragon.json"
    c = json.loads(f.read_text())
    c["render"]["bf16_light_math"] = True
    f.write_text(json.dumps(c))
    r = run_small(root, workload, 41)
    assert r["correct"] is False
    assert r["checks"]["rmse"]["value"] > 3 * r["checks"]["rmse"]["limit"]


@pytest.mark.parametrize("workload", CELLS)
def test_a_stale_glass_dragon_frame_fails(tmp_path, workload):
    """Two warm-up frames, and the window's first frame returns the
    previous frame's image: the orbit has moved, so it is not correct."""
    root = make_dragon_root(tmp_path / "checkout")
    mix = json.loads((root / "BENCHMARK.json").read_text())
    traffic = {w["name"]: w["traffic"] for w in mix["workloads"]}[workload]
    f = root / "benchmark" / "traffic" / f"{traffic}.json"
    t = json.loads(f.read_text())
    t["warmup_frames"] = 2
    f.write_text(json.dumps(t))
    last = {}

    def stale(v, params):
        image, diag = v.render(params)
        out = last.get("image", image)
        last["image"] = image
        return out, diag

    r = run_small(root, workload, 51, render_hook=stale)
    assert r["correct"] is False, r["checks"]


def test_the_seed_moves_only_the_viewer(dragon_root):
    """Two seeds build the same scene: the blob and the base scene come
    from the configuration's own seeds, and the blob is the last
    instance, the one the orbit turns."""
    import numpy as np

    from benchmark.core import registry, traffic

    bench = registry.load_benchmark(dragon_root)
    cfg = registry.load_config(bench, "glass_dragon", dragon_root)
    build = registry.scene_generator(cfg["generator"], dragon_root)
    a, b = (build(cfg["scene"], traffic.rng(seed, traffic.SCENE_STREAM))
            for seed in (4004, 2**31 + 77))
    assert repr(a.materials) == repr(b.materials)
    for ia, ib in zip(a.instances, b.instances, strict=True):
        assert (ia.primitive, ia.material, ia.scale) == (ib.primitive, ib.material, ib.scale)
        np.testing.assert_array_equal(ia.translation, ib.translation)
        np.testing.assert_array_equal(ia.rotation, ib.rotation)
    for pa, pb in zip(a.primitives, b.primitives, strict=True):
        np.testing.assert_array_equal(pa.positions, pb.positions)
    last = a.primitives[a.instances[-1].primitive]
    assert len(last.indices) == 2 * 24 * 48
