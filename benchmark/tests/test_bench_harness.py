"""The benchmark's own tests: traffic and scenes from the seed, parts
found by name, the result line, the forbidden imports, the refusals, and
the comparison that decides ``correct`` (the plain reference agrees with
the port's frame; the bf16 control and broken frames do not)."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from conftest import ROOT, make_small_root, run_small

from benchmark.core import cell, registry, traffic

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def _mix(name="orbit"):
    return json.loads((ROOT / "benchmark" / "traffic" / f"{name}.json").read_text())


def test_traffic_is_deterministic_and_seeded():
    mix = _mix()
    big = 2**31 + 7
    a, b, c = traffic.make_path(mix, big), traffic.make_path(mix, big), traffic.make_path(mix, 5)
    assert a == b
    assert (a.period_frames, a.phase, a.checked) != (c.period_frames, c.phase, c.checked)
    assert 2.0 / mix["dt"] <= a.period_frames <= 6.0 / mix["dt"]
    yaws = [a.target_yaw(k) for k in range(600)]
    assert min(yaws) >= 0.0 and max(yaws) <= 0.18 + 1e-12
    assert all(0 <= k < mix["check_within_frames"] for k in a.checked)


@pytest.mark.parametrize("config, triangles", [("dragon_attenuation", 134_222),
                                               ("sponza_foliage", 16_544)])
def test_scene_arrays_from_the_seed(config, triangles):
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{config}.json").read_text())
    assert cfg["triangles"] == triangles and "triangles" in cfg["reduced"]
    build = registry.scene_generator(cfg["generator"])

    def arrays(seed):
        return build(cfg["scene"], traffic.rng(seed, traffic.SCENE_STREAM))

    one, same, other = arrays(2**31 + 1), arrays(2**31 + 1), arrays(3)
    assert one.num_triangles == other.num_triangles == triangles

    def flat(s):
        parts = [p.positions for p in s.primitives] + [np.array(m["diffuse_factor"])
                                                      for m in s.materials]
        return np.concatenate([x.reshape(-1) for x in parts])

    assert np.array_equal(flat(one), flat(same))
    assert not np.array_equal(flat(one), flat(other))


def test_new_parts_are_found_by_name(tmp_path):
    """A configuration (with a scene generator of its own), a traffic mix
    and a per-layer metric added as files and entries, nothing edited."""
    root = make_small_root(tmp_path / "checkout")
    b = root / "benchmark"
    shutil.copy(b / "scenes" / "dragon.py", b / "scenes" / "blob2.py")
    cfg = json.loads((b / "configs" / "dragon_attenuation.json").read_text())
    cfg.update(name="blob2", generator="blob2")
    (b / "configs" / "blob2.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "orbit.json").read_text())
    mix["yaw_range"] = [0.0, 0.05]
    (b / "traffic" / "slow_orbit.json").write_text(json.dumps(mix))
    (b / "metrics" / "frames.profiled.py").write_text(
        "def read(trace):\n    return float(trace.frames)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="blob2",
                                 file="benchmark/configs/blob2.json"))
    bench["workloads"].append({"name": "blob2.slow", "config": "blob2",
                               "traffic": "slow_orbit", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "frames.profiled", "unit": "frames", "better": "higher",
                               "source": "program_counter", "layer": "harness",
                               "moves": "frame_ms", "workloads": ["blob2.slow"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    loaded = registry.load_benchmark(root)
    assert registry.load_config(loaded, "blob2", root)["generator"] == "blob2"
    assert registry.load_traffic("slow_orbit", root)["yaw_range"] == [0.0, 0.05]
    names = [m["name"] for m in registry.cell_metrics(loaded, "blob2.slow", "per_layer")]
    assert "frames.profiled" in names and "clip_peel.span_ms" not in names

    class Fake:
        frames = 12

    assert registry.metric_reader("frames.profiled", root)(Fake()) == 12.0
    r = run_small(root, "blob2.slow", 11)
    assert r["correct"] is True and set(r["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}


def test_result_line_keys(small_root, monkeypatch):
    r = run_small(small_root, "dragon.orbit", 21)
    assert set(r) == KEYS and list(r)[-1] == "checks"
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    json.dumps(r)
    monkeypatch.setattr(cell, "TRACE_FRAMES", 2)
    t = run_small(small_root, "dragon.orbit", 22, traced=True)
    assert set(t) == KEYS | {"breakdown"} and list(t)[-1] == "checks"
    assert {"busy_s", "window_s"} <= set(t["device"])
    assert set(t["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"render_frame.enqueue_ms", "device.idle_share", "binning.span_ms"} <= set(t["metrics"])
    # the span stretch hands the program its own pass ranges back
    from transmission_renderer_tpu_torch.render import frame, shading
    from transmission_renderer_tpu_torch.utils import profiling
    assert frame.pass_scope is profiling.pass_scope is shading.pass_scope
    assert "frame_ms" not in t["metrics"]
    # the window closes before the profiler starts: it is the untraced run's
    assert t["attempted"] == r["attempted"]
    json.dumps(t)


_IMPORTS = """
import sys
sys.path.insert(0, {root!r})
import importlib
for m in {mods!r}:
    importlib.import_module(m)
from benchmark.core import registry
bench = registry.load_benchmark()
for m in bench["per_layer"]:
    registry.metric_reader(m["name"])
print(" ".join(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def _top_level(mods) -> set:
    out = subprocess.run([sys.executable, "-c", _IMPORTS.format(root=str(ROOT), mods=mods)],
                         capture_output=True, text=True, check=True, cwd=str(ROOT))
    return set(out.stdout.split())


def test_nothing_loads_jax_and_the_reference_nothing_of_the_port():
    harness = _top_level(["benchmark.run", "benchmark.core.cell", "benchmark.work.walk",
                          "benchmark.reference.occlusion"])
    assert not harness & {"jax", "jaxlib", "flax", "transmission_renderer_tpu"}
    assert "transmission_renderer_tpu_torch" in harness
    reference = _top_level(["benchmark.reference.frame", "benchmark.reference.occlusion",
                            "benchmark.scenes.dragon", "benchmark.scenes.stress"])
    assert "transmission_renderer_tpu_torch" not in reference


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "transmission_renderer_tpu_x", sys)
    assert cell.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "transmission_renderer_tpu.ops", sys)
    assert cell.forbidden_modules() == ["transmission_renderer_tpu.ops"]


def _command(cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "foliage.orbit",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=str(cwd))


def test_without_a_card_the_command_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _command(ROOT)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_a_bare_checkout_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_out", "__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


@pytest.mark.parametrize("workload", ["dragon.orbit", "foliage.orbit", "dragon.rt_orbit"])
def test_reference_agrees_with_render_frame(small_root, workload):
    r = run_small(small_root, workload, 31)
    assert r["correct"] is True, r["checks"]
    assert r["failed"] == 0


@pytest.mark.parametrize("workload, config", [("foliage.orbit", "sponza_foliage"),
                                              ("dragon.orbit", "dragon_attenuation")])
def test_bf16_control_fails(tmp_path, workload, config):
    """The control: the program's own bfloat16 light math in place of
    float32 must come out not correct."""
    root = make_small_root(tmp_path / "checkout")
    f = root / "benchmark" / "configs" / f"{config}.json"
    c = json.loads(f.read_text())
    c["render"]["bf16_light_math"] = True
    f.write_text(json.dumps(c))
    r = run_small(root, workload, 41)
    assert r["correct"] is False
    assert r["checks"]["rmse"]["value"] > 3 * r["checks"]["rmse"]["limit"]


def _stale(root):
    """A frame that returns the previous frame's image unchanged."""
    last = {}

    def hook(v, params):
        image, diag = v.render(params)
        out = last.get("image", image)
        last["image"] = image
        return out, diag

    return hook


def _half(v, params):
    """Half of the frame left out: the lower rows never shaded."""
    image, diag = v.render(params)
    image = image.clone()
    image[image.shape[0] // 2:] = 0.0
    return image, diag


def _one_pixel(v, params):
    """One answer altered where it is produced: one pixel's red channel."""
    image, diag = v.render(params)
    image = image.clone()
    image[image.shape[0] // 3, image.shape[1] // 3, 0] += 0.25
    return image, diag


@pytest.mark.parametrize("workload", ["foliage.orbit", "dragon.orbit"])
@pytest.mark.parametrize("fault", ["stale", "half", "one_pixel"])
def test_broken_frames_are_not_correct(tmp_path, fault, workload):
    root = make_small_root(tmp_path / "checkout")
    if fault == "stale":
        # two warm-up frames: the window's first frame returns the second's image
        f = root / "benchmark" / "traffic" / "orbit.json"
        t = json.loads(f.read_text())
        t["warmup_frames"] = 2
        f.write_text(json.dumps(t))
    hook = {"stale": _stale(root), "half": _half, "one_pixel": _one_pixel}[fault]
    r = run_small(root, workload, 51, render_hook=hook)
    assert r["correct"] is False, r["checks"]


@pytest.mark.cuda
def test_command_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "foliage.orbit",
                          "--seed", "2147483659", "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, cwd=str(ROOT), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.splitlines()[-1])
    assert set(r) >= KEYS and r["correct"] is True
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert out.stderr.splitlines()[-1].startswith("check ")


def _least_walk(tree, o, d, t_max):
    """Per ray, recursively: (hit, pops, stage counts) of the least any-hit
    walk: a miss enters every node whose box it meets and tests every
    triangle of every leaf it enters; a hit takes one path of one node a
    level to the leaf with the fewest tests up to its first hit."""
    from benchmark.reference import occlusion as oc

    depth = len(tree.levels)
    inv = oc._inverse(d[None])[0]

    def leaf(i):
        h, stage = oc._tri(o[None, None], d[None, None], t_max[None, None], tree.leaf_tris[i][None])
        h, stage = h[0] & tree.leaf_real[i], stage[0]
        real = tree.leaf_real[i]
        last = int(h.to(torch.int8).argmax()) if bool(h.any()) else oc.LEAF - 1
        counts = [0, 0, 0, 0]
        for j in range(last + 1):
            if bool(real[j]):
                counts[int(stage[j])] += 1
        return bool(h.any()), counts

    def walk(lvl, node):
        """-> (pops, stage counts) of every entered pair below, and the
        fewest tests of a hitting leaf below with its stage counts."""
        pops, stages, best = 1, [0, 0, 0, 0], None
        for lane in range(oc.WIDE):
            child = node * oc.WIDE + lane
            if child >= tree.children[lvl]:
                continue
            box = tree.levels[lvl][node, lane]
            if not bool(oc._slab(o, inv, t_max, box)):
                continue
            if lvl + 1 == depth:
                h, c = leaf(child)
                sub_pops, sub_stages, sub_best = 0, c, (sum(c), c) if h else None
            else:
                sub_pops, sub_stages, sub_best = walk(lvl + 1, child)
            pops += sub_pops
            stages = [a + b for a, b in zip(stages, sub_stages)]
            if sub_best is not None and (best is None or sub_best[0] < best[0]):
                best = sub_best
        return pops, stages, best

    if float(t_max) <= 0:
        return False, 0, [0, 0, 0, 0]
    pops, stages, best = walk(0, 0)
    if best is None:
        return False, pops, stages
    return True, depth, best[1]


def test_walk_counts_the_least_any_hit_work():
    """Kernel 5's work: a ray that hits is charged the path to its
    cheapest hitting leaf, not every box it meets."""
    from benchmark.reference import occlusion as oc

    g = torch.Generator().manual_seed(5)
    n_tri = 700
    centre = torch.rand(n_tri, 3, generator=g) * 6
    tris = centre[:, None, :] + (torch.rand(n_tri, 3, 3, generator=g) - 0.5) * 0.8
    n_leaves = -(-n_tri // oc.LEAF)
    slots = torch.arange(n_leaves * oc.LEAF).clamp(max=n_tri - 1).reshape(n_leaves, oc.LEAF)
    tree = oc.refit(slots, tris)
    rays = 160
    o = torch.rand(rays, 3, generator=g) * 6
    d = torch.nn.functional.normalize(torch.randn(rays, 3, generator=g), dim=1)
    t_max = torch.rand(rays, generator=g) * 4
    t_max[:8] = 0.0
    hit, (pops, tests) = oc.occluded(tree, o, d, t_max, counts=True)
    want = [_least_walk(tree, o[i], d[i], t_max[i]) for i in range(rays)]
    assert hit.tolist() == [w[0] for w in want]
    assert 0 < int(hit.sum()) < rays - 8
    assert pops == sum(w[1] for w in want)
    assert tests == [sum(w[2][k] for w in want) for k in range(4)]


# a sliver of the dragon's blob (orbit, seed 4004, frame 32): clip-space
# vertices as the frame computes them in float32
SLIVER = [[0.9275342226028442, -3.1695566177368164, 0.009908081032335758, 4.605861186981201],
          [0.9480902552604675, -3.1573805809020996, 0.009908118285238743, 4.604023456573486],
          [0.9262080192565918, -3.165588140487671, 0.009908199310302734, 4.599979877471924]]


def test_reference_draws_no_pixel_past_a_triangles_box():
    """At pixel (1160, 170), 3 px right of the sliver's vertices, its
    float32 edge functions read "inside" where float64 reads outside: the
    reference does not draw it (nor any other pixel: no pixel centre lies
    inside the sliver)."""
    from benchmark.reference import raster

    clip = torch.tensor(SLIVER, dtype=torch.float32)
    tri = torch.tensor([[0, 1, 2]])
    records, valid, bbox = raster.setup(clip, tri, torch.tensor([True]), 1920, 1080)
    assert bool(valid[0]) and int(bbox[0, 2]) < 1160
    px, py = torch.tensor([1160]), torch.tensor([170])
    inside32, _ = raster.fragment_test(records, raster.edge_values(
        records, *raster.pixel_ndc(px, py, 1920, 1080)))
    assert bool(inside32[0])
    r64 = torch.cat([-raster._adjugate3(clip.double()[:, [0, 1, 3]].T[None]).reshape(1, 9),
                     clip.double()[:, 2][None], clip.double()[:, 3][None]], 1)
    nx = (1160.5 * 2.0 / 1920) - 1.0
    ny = (170.5 * 2.0 / 1080) - 1.0
    inside64, _ = raster.fragment_test(r64, raster.edge_values(r64, nx, ny))
    assert not bool(inside64[0])
    keys = raster.zbuffer(records, bbox, torch.tensor([0]), 1920, 1080)
    assert int((keys != 0).sum()) == 0
