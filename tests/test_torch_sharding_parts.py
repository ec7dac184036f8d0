"""The pieces the sharded frame threads through the port, and --devices.

- ``shade_transmission_flat`` on the kernel path with a caller's
  ``fb_sampler``: given the single frame's own pyramid fetch as the
  sampler, it gives the fused path's result bit for bit, and kernel 4
  (the fused fetch) does not run.
- ``render/frame.py::_up2(nxt_override=...)`` equals the reference's on
  seeded inputs, and with the default neighbours it equals ``_up2``.
- ``interpolate_gbuffer(row_offset=...)`` on a band of a visibility
  buffer: within the reference's interpolation tolerance of the
  reference's (tests/test_torch_vis_frame.py: atol 1e-5, rtol 1e-4) and
  equal bit for bit to the whole frame's rows.
- ``rasterize_gbuffer_tiles(n_tiles_global=...)`` over bins of a grid
  padded below the frame: the frame's tiles equal the unpadded call's
  channels bit for bit, and the padded tiles race nothing.
- The CLI: ``--cpu --devices 2`` on the attenuation scene at 128x64
  within max abs 2e-6 of ``--devices 1``, writing one PNG; beside
  ``--ray-tracing``, and with fewer cards than ranks, it exits 2 with the
  reference's CLI's own message.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from transmission_renderer_tpu import cli as jcli
from transmission_renderer_tpu.ops.raster import TriangleSetup as JSetup
from transmission_renderer_tpu.ops.raster import VisibilityBuffer as JVis
from transmission_renderer_tpu.render.frame import _up2 as jup2
from transmission_renderer_tpu.render.gbuffer import interpolate_gbuffer as jinterpolate
from transmission_renderer_tpu_torch import cli
from transmission_renderer_tpu_torch.config import (
    BUCKET_ALPHA_CLIP,
    BUCKET_OPAQUE,
    BUCKET_TRANSMISSION,
    RenderConfig,
)
from transmission_renderer_tpu_torch.models import procedural as pproc
from transmission_renderer_tpu_torch.ops import raster, raster_gbuf, raster_vis, tap_finish
from transmission_renderer_tpu_torch.ops.cull import (
    bucket_triangle_masks,
    cull_instances,
    transform_vertices,
)
from transmission_renderer_tpu_torch.ops.mipchain import sample_pyramid_lod
from transmission_renderer_tpu_torch.pbr.lights import pack_lights, point_light
from transmission_renderer_tpu_torch.render import frame as pframe
from transmission_renderer_tpu_torch.render.gbuffer import interpolate_gbuffer
from transmission_renderer_tpu_torch.scene.camera import CameraRig

torch.set_num_threads(1)

DRAGON_CAM = ((0.0, 2.2, 1.5), -0.25)
SMALL = ["--width", "128", "--height", "64"]


def _frame_inputs(builder, cfg, cam=DRAGON_CAM):
    scene, dl, flags = builder.finish_bundle(device="cpu")
    rig = CameraRig()
    rig.camera.position = np.array(cam[0], np.float32)
    rig.camera.pitch = cam[1]
    params = pframe.make_frame_params(cfg, rig.camera.view_matrix(), rig.camera.position,
                                      rig.sun_dir(), device="cpu")
    lights = pack_lights([point_light([0.0, 0.8, 0.0], [1.0, 0.0, 0.0], 5.0),
                          point_light([8.0, 0.8, 0.0], [0.0, 1.0, 0.0], 10.0)], device="cpu")
    return scene, dl, flags, params, lights


def test_transmission_kernel_path_takes_the_callers_sampler(monkeypatch):
    cfg = RenderConfig(width=128, height=72, use_pallas_raster=True)
    scene, dl, flags, params, lights = _frame_inputs(
        pproc.build_dragon_scene(stacks=40, sectors=80, roughness_override=0.25), cfg)
    calls = []
    original = pframe.shade_transmission_flat

    def recording(*args, **kwargs):
        out = original(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    monkeypatch.setattr(pframe, "shade_transmission_flat", recording)
    pframe.render_frame(scene, dl, params, lights, cfg, flags=flags)
    assert len(calls) == 1
    (p_scene, g, ctx, pyramid, level_set, px, py, block_py, block_px0), kwargs, fused = calls[0]
    assert not kwargs and ctx.pallas_shade and block_py is not None
    assert int(g.valid.sum()) > 100
    tap_finish.FETCH_KERNEL.recorder = []
    try:
        got = original(p_scene, g, ctx, None, None, px, py, block_py, block_px0,
                       fb_sampler=lambda uv, lod: sample_pyramid_lod(pyramid, uv, lod,
                                                                     level_set))
        assert tap_finish.FETCH_KERNEL.recorder == []
    finally:
        tap_finish.FETCH_KERNEL.recorder = None
    assert torch.equal(got, fused)


@pytest.mark.parametrize("axis", [0, 1])
def test_up2_nxt_override_matches_reference(axis):
    rng = np.random.default_rng(12)
    a = rng.random((6, 5, 2), dtype=np.float32)
    nxt = rng.random((6, 5, 2), dtype=np.float32)
    got = pframe._up2(torch.from_numpy(a), axis, nxt_override=torch.from_numpy(nxt))
    ref = np.asarray(jup2(jnp.asarray(a), axis, nxt_override=jnp.asarray(nxt)))
    np.testing.assert_array_equal(got.numpy(), ref)
    n = a.shape[axis]
    shifted = np.concatenate([np.take(a, range(1, n), axis), np.take(a, [n - 1], axis)], axis)
    assert torch.equal(pframe._up2(torch.from_numpy(a), axis,
                                   nxt_override=torch.from_numpy(shifted)),
                       pframe._up2(torch.from_numpy(a), axis))


def test_interpolate_gbuffer_row_offset_matches_reference():
    cfg = RenderConfig(width=128, height=64, tile_w=32, tile_h=8)
    scene, dl, flags, params, lights = _frame_inputs(
        pproc.build_dragon_scene(stacks=40, sectors=80, roughness_override=0.25), cfg)
    world, nrm, uvs, clip, scale = transform_vertices(scene, dl, params.proj_view)
    visible = cull_instances(scene, params.view, params.frustum_x_xz, params.frustum_y_yz,
                             cfg.z_near)
    mask = bucket_triangle_masks(dl.tri_inst, dl.tri_bucket, visible,
                                 (BUCKET_OPAQUE, BUCKET_ALPHA_CLIP))
    setup = raster.setup_triangles(clip, dl.tri_vtx, mask, cfg.width, cfg.height,
                                   cfg.tile_w, cfg.tile_h)
    bins = raster.bin_triangles_materialized(setup, cfg.tiles_x, cfg.tiles_y,
                                             cfg.max_tiles_per_tri, cfg.max_tris_per_tile,
                                             cfg.max_big_tris)
    vis = raster_vis.rasterize(setup, bins, cfg.width, cfg.height, cfg.tile_w, cfg.tile_h)
    args = (dl.tri_vtx, dl.tri_material, scale, world, nrm, uvs, cfg.width, cfg.height)
    whole = interpolate_gbuffer(vis, setup, *args)
    r0, r1 = 24, 48
    band = raster.VisibilityBuffer(*(a[r0:r1] for a in vis))
    got = interpolate_gbuffer(band, setup, *args, row_offset=r0)
    assert int(got.valid.sum()) > 500
    # the reference's set-up has no pixel box (the interpolation does not read it)
    ref = jinterpolate(JVis(*(jnp.asarray(a.numpy()) for a in band)),
                       JSetup(*(jnp.asarray(a.numpy()) for a in setup[:5])),
                       *(jnp.asarray(a.numpy()) for a in args[:6]), cfg.width, cfg.height,
                       row_offset=r0)
    for f in got._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   atol=1e-5, rtol=1e-4, err_msg=f)
        assert torch.equal(getattr(got, f), getattr(whole, f)[r0:r1]), f


def test_gbuffer_raster_on_a_padded_grid_equals_the_frames_grid():
    cfg = RenderConfig(width=256, height=64, use_pallas_raster=True)
    scene, dl, flags, params, lights = _frame_inputs(
        pproc.build_dragon_scene(stacks=40, sectors=80, roughness_override=0.25), cfg)
    world, nrm, uvs, clip, scale = transform_vertices(scene, dl, params.proj_view)
    visible = cull_instances(scene, params.view, params.frustum_x_xz, params.frustum_y_yz,
                             cfg.z_near)
    mask = bucket_triangle_masks(dl.tri_inst, dl.tri_bucket, visible,
                                 (BUCKET_OPAQUE, BUCKET_TRANSMISSION))
    tri_class = (dl.tri_bucket == BUCKET_TRANSMISSION).to(torch.int32)
    setup = raster.setup_triangles(clip, dl.tri_vtx, mask, cfg.width, cfg.height, 128, 8)
    records = raster_gbuf.pack_gbuf_payload(setup, dl.tri_vtx, dl.tri_material, scale,
                                            world, nrm, uvs, tri_class)
    tiers = ((128, 512), (0, 32))
    tiles_x, tiles_y, pad_rows = cfg.tiles_x, cfg.tiles_y, 4
    n_frame, n_padded = tiles_x * tiles_y, tiles_x * (tiles_y + pad_rows)
    bins = raster.bin_triangles(setup, tiles_x, tiles_y, 2, tri_class, 2, tiers)
    bins_p = raster.bin_triangles(setup, tiles_x, tiles_y + pad_rows, 2, tri_class, 2, tiers)
    # the padded grid's class count is not what the frame's grid implies
    assert raster_gbuf._num_classes(bins_p.tile_start, cfg.width, cfg.height) != 2
    ids = torch.arange(n_frame, dtype=torch.int32)
    pad_ids = torch.arange(n_frame, n_padded, dtype=torch.int32)
    for pass_class in (0, 1):
        ref = raster_gbuf.rasterize_gbuffer_tiles(
            raster_gbuf.gather_gbuf_payload(records, bins), ids, bins.tile_start, 0,
            cfg.width, cfg.height, pass_class=pass_class)
        payload_p = raster_gbuf.gather_gbuf_payload(records, bins_p)
        got = raster_gbuf.rasterize_gbuffer_tiles(
            payload_p, ids, bins_p.tile_start, 0, cfg.width, cfg.height,
            pass_class=pass_class, n_tiles_global=n_padded)
        assert int((ref["tri"] >= 0).sum()) > 100
        for name, a in ref.items():
            assert torch.equal(got[name], a), name
        empty = raster_gbuf.rasterize_gbuffer_tiles(
            payload_p, pad_ids, bins_p.tile_start, 0, cfg.width, cfg.height,
            pass_class=pass_class, n_tiles_global=n_padded)
        assert bool((empty["tri"] == -1).all())


def test_cli_devices_2_equals_devices_1(tmp_path):
    argv = ["--cpu", "--procedural", "attenuation"] + SMALL
    one, two = [], []
    assert cli.main(argv + ["-o", str(tmp_path / "one.png")], frames_out=one) == 0
    assert cli.main(argv + ["--devices", "2", "-o", str(tmp_path / "two.png")],
                    frames_out=two) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["one.png", "two.png"]
    assert one[0].shape == two[0].shape == (64, 128, 3)
    assert float(np.abs(one[0] - two[0]).max()) <= 2e-6


def test_cli_devices_refusals_are_the_references(tmp_path, capsys, monkeypatch):
    """--devices 2 beside --ray-tracing, and --devices 2 on one card (here
    the reference's one CPU device; the port's card count faked to 1):
    exit 2 with the reference's CLI's messages, no PNG."""
    base = ["--cpu", "--procedural", "test", "-o", str(tmp_path / "r.png")] + SMALL
    for extra in (["--devices", "2", "--ray-tracing"], ["--devices", "2"]):
        assert jcli.main(base + extra) == 2
        ref = capsys.readouterr().err.strip().splitlines()[-1]
        port_argv = base + extra
        if "--ray-tracing" not in extra:
            port_argv = [a for a in port_argv if a != "--cpu"]
            monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
            monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        assert cli.main(port_argv) == 2
        assert capsys.readouterr().err.strip().splitlines()[-1] == ref
    assert ref == "error: --devices 2 but only 1 available"
    assert not (tmp_path / "r.png").exists()
