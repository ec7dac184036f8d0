"""The port's command line and the pieces it adds, vs the JAX package's.

- ``cluster_wireframe_overlay`` on the config's own cluster AABBs: equal
  to the reference's bit for bit;
- ``cli.main`` on the CPU against the reference's ``cli.main`` at 128x72:
  ``--procedural test``, ``--as-debug`` on the low-detail dragon, and
  ``--frames 2 --spotlights --rotate-model`` (each PNG within the goldens'
  sRGB RMSE 4e-3; the frames of the last must differ);
- ``--interactive`` on a scripted stdin, ``--profile`` (the pass ranges in
  the trace), ``--cluster-wireframe`` and ``--debug-clusters``;
- the quality flags ``--half-res-refraction``, ``--quad-taps`` and
  ``--bf16-lights`` on the low-detail dragon against the reference's
  ``cli.main`` (each PNG within the goldens' sRGB RMSE 4e-3, and each flag
  changes the port's frame);
- the modes of ROADMAP queue 1 (``--devices 2``, ``--debug-checks``)
  render and exit 2 only where the reference's refuses them, and without
  a card and without ``--cpu`` the CLI exits non-zero;
- ``CameraRig`` (update, move_relative, rotate, update_sun) and
  ``quat_from_rotation_y`` equal the reference's bit for bit, and
  ``quat_mul`` within 1e-6 (the reference's compiler may contract its
  four-term sums).
"""

import io
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from transmission_renderer_tpu import cli as jcli
from transmission_renderer_tpu.config import RenderConfig as JConfig
from transmission_renderer_tpu.pbr import cluster_coefficients as jcoeffs
from transmission_renderer_tpu.pbr.clustering import write_cluster_data as jwrite_clusters
from transmission_renderer_tpu.render.cluster_debug import cluster_wireframe_overlay as joverlay
from transmission_renderer_tpu.scene.camera import CameraRig as JRig
from transmission_renderer_tpu.scene.camera import perspective_matrix_reversed
from transmission_renderer_tpu.scene.types import quat_from_rotation_y as jquat_y
from transmission_renderer_tpu.scene.types import quat_mul as jquat_mul
from transmission_renderer_tpu_torch import cli
from transmission_renderer_tpu_torch.render.cluster_debug import cluster_wireframe_overlay
from transmission_renderer_tpu_torch.scene.camera import CameraRig
from transmission_renderer_tpu_torch.scene.types import quat_from_rotation_y, quat_mul
from transmission_renderer_tpu_torch.utils.png import read_png

torch.set_num_threads(1)

SMALL = ["--width", "128", "--height", "72"]
GOLDEN_RMSE = 4e-3


def _srgb(path):
    return read_png(path)[..., :3] / 255.0


def _rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)))


# ---------------------------------------------------------------------------
# the overlay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slice_index", [5, -1])
def test_cluster_wireframe_overlay_matches_reference(slice_index):
    cfg = JConfig(width=128, height=72)
    proj = perspective_matrix_reversed(cfg.width, cfg.height, cfg.vertical_fov,
                                       cfg.z_near, cfg.z_far)
    amin, amax = jwrite_clusters(jnp.linalg.inv(jnp.asarray(proj)), (cfg.width, cfg.height),
                                 (cfg.num_clusters_x, cfg.num_clusters_y),
                                 jcoeffs(cfg.z_near, cfg.z_far, cfg.num_depth_slices))
    amin, amax = np.asarray(amin), np.asarray(amax)
    if slice_index >= 0:
        per = cfg.num_clusters_x * cfg.num_clusters_y
        amin = amin[slice_index * per : (slice_index + 1) * per]
        amax = amax[slice_index * per : (slice_index + 1) * per]
    img = np.random.default_rng(3).uniform(0, 1, (72, 128, 3)).astype(np.float32)
    want = np.asarray(joverlay(jnp.asarray(img), jnp.asarray(amin), jnp.asarray(amax),
                               jnp.asarray(proj)))
    got = cluster_wireframe_overlay(torch.from_numpy(img), torch.from_numpy(amin),
                                    torch.from_numpy(amax), torch.from_numpy(proj)).numpy()
    assert (got != img).any()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# cli.main against the reference's
# ---------------------------------------------------------------------------

RUNS = {
    "test": ["--procedural", "test"],
    "as_debug": ["--procedural", "dragon", "--detail", "0.2", "--as-debug"],
    "spots_rotate": ["--procedural", "test", "--frames", "2", "--spotlights",
                     "--rotate-model"],
}


@pytest.fixture(scope="module", params=sorted(RUNS))
def cli_pair(request, tmp_path_factory):
    """(reference PNG paths, port PNG paths, port frames) of one run."""
    d = tmp_path_factory.mktemp(request.param)
    argv = RUNS[request.param] + SMALL
    n = int(argv[argv.index("--frames") + 1]) if "--frames" in argv else 1

    def paths(tag):
        if n == 1:
            return [str(d / f"{tag}.png")]
        return [str(d / f"{tag}_{k:03d}.png") for k in range(n)]

    assert jcli.main(argv + ["--cpu", "-o", str(d / "ref.png")]) == 0
    frames = []
    assert cli.main(argv + ["--cpu", "-o", str(d / "port.png")], frames_out=frames) == 0
    return paths("ref"), paths("port"), frames, request.param


def test_cli_matches_reference(cli_pair):
    ref_paths, port_paths, frames, name = cli_pair
    assert len(frames) == len(port_paths)
    for r, p, f in zip(ref_paths, port_paths, frames):
        got = _srgb(p)
        assert got.shape == (72, 128, 3) and np.isfinite(f).all()
        assert _rmse(got, _srgb(r)) < GOLDEN_RMSE, (name, p)
    if name == "spots_rotate":
        assert np.abs(frames[1] - frames[0]).max() > 1e-3
    if name == "as_debug":
        assert (frames[0] > 0).any() and (frames[0] == 0).any()


def test_interactive_scripted_stdin(tmp_path, monkeypatch):
    """Three <enter>s render three frames along the keys' moves; x quits."""
    monkeypatch.setattr("sys.stdin", io.StringIO("ww\nji\nu;\nx\nww\n"))
    frames = []
    out = str(tmp_path / "i.png")
    assert cli.main(["--cpu", "--interactive", "--procedural", "test", "-o", out] + SMALL,
                    frames_out=frames) == 0
    assert len(frames) == 3
    assert sorted(os.listdir(tmp_path)) == ["i_000.png", "i_001.png", "i_002.png"]
    assert all(np.abs(frames[k + 1] - frames[k]).max() > 1e-3 for k in range(2))


def test_profile_writes_pass_ranges(tmp_path):
    trace_dir = str(tmp_path / "prof")
    assert cli.main(["--cpu", "--procedural", "test", "--profile", trace_dir,
                     "-o", str(tmp_path / "p.png")] + SMALL) == 0
    with open(os.path.join(trace_dir, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    for pass_name in ("geometry", "binning", "raster_opaque", "clustering",
                      "shade_opaque", "tonemap"):
        assert pass_name in names, pass_name


def test_debug_views_render(tmp_path):
    """--debug-clusters and --cluster-wireframe on the CPU's
    visibility-buffer branch (the tensor shade): finite, in [0, 1], and
    the wireframe's colour drawn over the false colour."""
    frames = []
    assert cli.main(["--cpu", "--procedural", "test", "--debug-clusters",
                     "--cluster-wireframe", "5", "-o", str(tmp_path / "c.png")] + SMALL,
                    frames_out=frames) == 0
    img = frames[0]
    assert np.isfinite(img).all() and img.min() >= 0.0 and img.max() <= 1.0
    wire = np.all(np.isclose(img, (0.1, 1.0, 0.2)), axis=-1)
    assert 0 < wire.sum() < wire.size


@pytest.mark.parametrize("flag,item", [
    (["--devices", "2"], "item 8"),
    (["--debug-checks"], "item 10"),
])
def test_unported_modes_exit_2(flag, item, tmp_path, capsys):
    """The CLI modes of ROADMAP queue 1, each rendering since it was
    ported and exiting 2 only beside the flags the reference's CLI refuses
    with it: --devices 2 (item 8) on two CPU ranks, refused beside
    --ray-tracing (tests/test_torch_sharding_parts.py holds its frame and
    messages to the reference's); --debug-checks (item 10) with no check
    report (tests/test_torch_checks.py has all its refusals)."""
    argv = ["--cpu", "--procedural", "test", "-o", str(tmp_path / "u.png")] + SMALL + flag
    assert cli.main(argv) == 0
    err = capsys.readouterr().err
    assert "out-of-bounds" not in err and "not ported" not in err
    assert os.listdir(tmp_path) == ["u.png"]
    assert cli.main(argv + ["--ray-tracing"]) == 2
    assert ("single-device non-RT" if item == "item 10" else "unsupported on the sharded path") \
        in capsys.readouterr().err


@pytest.mark.parametrize("flag", ["--half-res-refraction", "--quad-taps", "--bf16-lights"])
def test_quality_flags_match_reference(flag, tmp_path):
    """Each quality flag renders the low-detail dragon (glass over a
    checker floor) as the reference's CLI does, and moves the frame."""
    argv = ["--cpu", "--procedural", "dragon", "--detail", "0.2"] + SMALL
    assert jcli.main(argv + [flag, "-o", str(tmp_path / "ref.png")]) == 0
    frames = []
    assert cli.main(argv + [flag, "-o", str(tmp_path / "port.png")], frames_out=frames) == 0
    assert cli.main(argv + ["-o", str(tmp_path / "exact.png")], frames_out=frames) == 0
    got = _srgb(str(tmp_path / "port.png"))
    assert got.shape == (72, 128, 3) and np.isfinite(frames[0]).all()
    assert _rmse(got, _srgb(str(tmp_path / "ref.png"))) < GOLDEN_RMSE
    assert np.abs(frames[0] - frames[1]).max() > 1e-3


def test_no_card_exits_nonzero(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["--procedural", "test", "-o", str(tmp_path / "n.png")] + SMALL) != 0
    assert "--cpu" in capsys.readouterr().err
    assert not os.listdir(tmp_path)


def test_parser_matches_reference():
    """Every flag of the reference's parser, with its default, and the
    port's own ``--spans`` (the frame tracer's trace), off by default."""
    ref = {a.dest: a.default for a in jcli.build_parser()._actions}
    got = {a.dest: a.default for a in cli.build_parser()._actions}
    assert got == {**ref, "spans": None}


# ---------------------------------------------------------------------------
# the camera rig and the quaternion helpers
# ---------------------------------------------------------------------------

def test_camera_rig_matches_reference():
    rng = np.random.default_rng(8)
    jr, pr = JRig(), CameraRig()
    for step in range(60):
        op = int(rng.integers(0, 4))
        if op == 0:
            args = [float(x) for x in rng.uniform(-1, 1, 3)] + [float(rng.uniform(0.1, 2))]
            jr.move_relative(*args)
            pr.move_relative(*args)
        elif op == 1:
            args = [float(x) for x in rng.uniform(-0.3, 0.3, 2)]
            jr.rotate(*args)
            pr.rotate(*args)
        elif op == 2:
            keys = [bool(b) for b in rng.integers(0, 2, 4)]
            jr.update_sun(*keys, 1 / 60)
            pr.update_sun(*keys, 1 / 60)
        dt = float(rng.choice([1 / 60, 1 / 30]))
        jr.update(dt)
        pr.update(dt)
        for a, b in ((pr.camera.position, jr.camera.position),
                     (pr.target_position, jr.target_position),
                     (pr.sun_velocity, jr.sun_velocity),
                     (pr.camera.view_matrix(), jr.camera.view_matrix()),
                     (pr.sun_dir(), jr.sun_dir())):
            np.testing.assert_array_equal(a, b, err_msg=f"step {step}")
        assert (pr.camera.yaw, pr.camera.pitch, pr.target_yaw, pr.target_pitch,
                pr.sun_yaw, pr.sun_pitch) == (jr.camera.yaw, jr.camera.pitch, jr.target_yaw,
                                              jr.target_pitch, jr.sun_yaw, jr.sun_pitch)


def test_quaternion_helpers_match_reference():
    rng = np.random.default_rng(9)
    a = rng.normal(size=(64, 4)).astype(np.float32)
    b = rng.normal(size=(64, 4)).astype(np.float32)
    want = np.asarray(jquat_mul(jnp.asarray(a), jnp.asarray(b)))
    got = quat_mul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for angle in (0.0, 1.0 / 60.0, 1.3, -2.0):
        np.testing.assert_array_equal(quat_from_rotation_y(angle), jquat_y(angle))


def test_multi_glb_transmission_tiles_are_the_references():
    """tests/test_torch_card_hd.py renders tests/assets/multi.glb through the
    CLI at its defaults on the card (1080p, camera (0, 2.2, 1.5) pitch -0.25), where
    its glass quad covers more 8x128 tiles than the default sparse
    transmissive raster holds (transmission_tile_cap_frac 0.25 of 2025:
    507), so --check-nan reports that overflow. The count it pins,
    MULTI_GLB_TRANSMISSION_TILES, is the reference's own: the tiles
    holding a class-1 record in its kernel-branch binning
    (render/frame.py:1080-1104), computed here by its setup_triangles /
    bin_triangles."""
    import jax

    from card_defs import MULTI_GLB_TRANSMISSION_TILES
    from transmission_renderer_tpu.config import (
        BUCKET_ALPHA_CLIP, BUCKET_OPAQUE, BUCKET_TRANSMISSION, BUCKET_TRANSMISSION_ALPHA_CLIP)
    from transmission_renderer_tpu.ops.cull import bucket_triangle_masks, cull_instances
    from transmission_renderer_tpu.ops.raster import bin_triangles, setup_triangles
    from transmission_renderer_tpu.render import make_frame_params as jparams
    from transmission_renderer_tpu.scene.builder import SceneBuilder as JBuilder
    from transmission_renderer_tpu.scene.gltf import load_gltf as jload
    from transmission_renderer_tpu.scene.types import Similarity, similarity_apply

    cfg = JConfig(width=1920, height=1080)
    b = JBuilder()
    jload(os.path.join(os.path.dirname(__file__), "assets", "multi.glb"), b)
    scene, dl, flags = b.finish_bundle()
    rig = JRig()
    rig.camera.position = np.array([0.0, 2.2, 1.5], np.float32)
    rig.camera.pitch = -0.25
    params = jparams(cfg, rig.camera.view_matrix(), rig.camera.position, rig.sun_dir())

    @jax.jit
    def class1_tiles(scene, dl, params):
        inst = Similarity(translation=scene.inst_transform.translation[dl.vtx_inst],
                          scale=scene.inst_transform.scale[dl.vtx_inst],
                          rotation=scene.inst_transform.rotation[dl.vtx_inst])
        pos = similarity_apply(inst, scene.positions[dl.vtx_src])
        clip = jnp.concatenate([pos, jnp.ones_like(pos[:, :1])], -1) @ params.proj_view.T
        visible = cull_instances(scene, params.view, params.frustum_x_xz,
                                 params.frustum_y_yz, cfg.z_near)
        mask = bucket_triangle_masks(dl.tri_inst, dl.tri_bucket, visible, (
            BUCKET_OPAQUE, BUCKET_ALPHA_CLIP, BUCKET_TRANSMISSION,
            BUCKET_TRANSMISSION_ALPHA_CLIP))
        trans = (dl.tri_bucket == BUCKET_TRANSMISSION) | (
            dl.tri_bucket == BUCKET_TRANSMISSION_ALPHA_CLIP)
        clipped = (dl.tri_bucket == BUCKET_ALPHA_CLIP) | (
            dl.tri_bucket == BUCKET_TRANSMISSION_ALPHA_CLIP)
        setup = setup_triangles(clip, dl.tri_vtx, mask, cfg.width, cfg.height,
                                cfg.tile_w, cfg.tile_h)
        bins = bin_triangles(setup, cfg.tiles_x, cfg.tiles_y, cfg.pallas_tiles_per_tri,
                             cfg.max_tris_per_tile, cfg.pallas_max_big_tris,
                             materialize=False,
                             class_flags=trans.astype(jnp.int32) + 2 * clipped.astype(jnp.int32),
                             num_classes=4, mid_tile_cap=cfg.pallas_mid_tile_cap,
                             max_mid_tris=cfg.pallas_max_mid_tris, tiers=cfg.pallas_tiers)
        base = jnp.arange(cfg.tiles_x * cfg.tiles_y) * 4 + 1
        return jnp.sum(bins.tile_start[base + 1] > bins.tile_start[base])

    assert flags.has_alpha_clip and flags.has_transmission
    tiles = int(class1_tiles(scene, dl, params))
    cap = int(np.ceil(cfg.tiles_x * cfg.tiles_y * cfg.transmission_tile_cap_frac))
    assert (tiles, cap) == (MULTI_GLB_TRANSMISSION_TILES, 507)
    assert tiles > cap
