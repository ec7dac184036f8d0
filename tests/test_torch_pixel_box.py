"""The rasters' pixel box (kernels 1 and 6, plain versions): a record
covers a pixel only inside its triangle's screen box widened by one
pixel. A sliver's float32 edge functions can read "inside" past that box
(the JAX package bins and draws such pixels); the port draws none there,
and a triangle with a vertex behind the eye still covers to the screen's
edge."""

import numpy as np
import pytest
import torch
from pixel_box_defs import SLIVER, SLIVER_PIXEL, pixel_box

from transmission_renderer_tpu_torch.ops import raster, raster_gbuf, raster_vis

torch.set_num_threads(1)

TIERS = ((8, 4096), (128, 512), (2048, 64), (0, 16))


def _gbuf_case(clip, tris, width, height, box=None):
    """(payload, tile ids of every tile, tile_start, set-up) of kernel 1's
    records of ``tris`` in class 0; ``box`` replaces every record's pixel
    box."""
    t = len(tris)
    clip_t, tris_t = torch.tensor(clip, dtype=torch.float32), torch.tensor(tris, dtype=torch.int32)
    setup = raster.setup_triangles(clip_t, tris_t, torch.ones(t, dtype=torch.bool), width,
                                   height, 128, 8)
    tiles_x, tiles_y = -(-width // 128), -(-height // 8)
    cls = torch.zeros(t, dtype=torch.int32)
    bins = raster.bin_triangles(setup, tiles_x, tiles_y, 8, cls, 2, TIERS)
    n_v = clip_t.shape[0]
    rec = raster_gbuf.pack_gbuf_payload(
        setup, tris_t, torch.zeros(t, dtype=torch.int32), torch.ones(t),
        torch.zeros(n_v, 3), torch.zeros(n_v, 3), torch.zeros(n_v, 2), cls)
    if box is not None:
        b = raster_gbuf.BOX_F32
        rec[:, b : b + 4] = torch.tensor(box, dtype=torch.float32)
    ids = torch.arange(tiles_x * tiles_y, dtype=torch.int32)
    return raster_gbuf.gather_gbuf_payload(rec, bins), ids, bins.tile_start, setup


def test_sliver_box_is_the_widened_screen_box():
    """The set-up's box and the record's floats 44-47 are the numpy box;
    the sliver's pixel lies 3 px right of its vertices' box."""
    payload, _, _, setup = _gbuf_case(SLIVER, [[0, 1, 2]], 1920, 1080)
    want = pixel_box(SLIVER, [[0, 1, 2]], 1920, 1080)
    np.testing.assert_array_equal(setup.pixel_box.numpy(), want)
    assert bool(setup.valid[0]) and want[0, 2] + 1 < SLIVER_PIXEL[0]
    b = raster_gbuf.BOX_F32
    rec = payload[0].reshape(-1, raster_gbuf.REC_F32)
    # the sliver's rows (not the sentinels' nor the zero rows after them)
    live = rec[(rec[:, 15] >= 0) & (rec[:, :9] != 0).any(1)][:, b : b + 4].numpy()
    assert len(live) > 0
    np.testing.assert_array_equal(live, np.broadcast_to(want, live.shape))


@pytest.mark.parametrize("segment", [None, 1])
def test_kernel1_plain_draws_no_sliver_pixel(segment):
    """At 1920x1080 the sliver goes through setup_triangles,
    pack_gbuf_payload and the plain race (sequential and segmented) and
    draws no pixel; with its box widened to the screen it draws
    (1160, 170), as the JAX package does."""
    x, y = SLIVER_PIXEL
    tile = (y // 8) * 15 + x // 128
    for box, drawn in ((None, []), ([0.0, 0.0, 1919.0, 1079.0], [(y % 8, x % 128)])):
        payload, ids, ts, _ = _gbuf_case(SLIVER, [[0, 1, 2]], 1920, 1080, box)
        ids = ids[tile : tile + 1]
        ch = raster_gbuf.rasterize_gbuffer_tiles_plain(payload, ids, ts, 0, 1920, 1080,
                                                       pass_class=0, segment=segment)
        assert [tuple(p) for p in torch.nonzero(ch["tri"][0] >= 0).tolist()] == drawn
        assert raster_gbuf.covered_pairs(payload, ids, ts, 1920, 1080, pass_class=0) == len(drawn)


@pytest.mark.parametrize("xla_order", [True, False])
def test_kernel6_plain_draws_no_sliver_pixel(xla_order):
    """Kernel 6's plain version over the sliver's materialised bins at
    1920x1080, in both walk orders, draws no pixel."""
    clip = torch.tensor(SLIVER, dtype=torch.float32)
    tris = torch.tensor([[0, 1, 2]], dtype=torch.int32)
    setup = raster.setup_triangles(clip, tris, torch.tensor([True]), 1920, 1080, 128, 8)
    bins = raster.bin_triangles_materialized(setup, 15, 135, 8, 64, 16)
    payload = raster_vis.gather_bin_payload(setup, bins)
    x, y = SLIVER_PIXEL
    tid = torch.tensor([(y // 8) * 15 + x // 128], dtype=torch.int32)
    count = bins.tile_tri_count[tid.long()] if xla_order else (
        bins.tile_start[tid.long() + 1] - bins.tile_start[tid.long()])
    assert int(count[0]) == 1
    big = torch.zeros(1, dtype=torch.int32)
    args = (payload, tid, bins.tile_start[tid.long()].contiguous(), count.to(torch.int32), big,
            1920, 1080, 128, 8)
    for segment in (None, 1):
        tri, _, _, _ = raster_vis.raster_vis_plain(*args, xla_order=xla_order, segment=segment)
        assert int((tri >= 0).sum()) == 0
    assert raster_vis.covered_pairs(*args) == 0


def _behind_the_eye(width, height):
    """A floor quad under a camera close to it: each triangle has a vertex
    behind the eye and covers the screen's lower part."""
    from transmission_renderer_tpu_torch.scene.camera import (
        look_at_rh, perspective_matrix_reversed)

    pv = perspective_matrix_reversed(width, height) @ look_at_rh(
        (0.0, 1.0, 0.0), (0.0, 0.5, -3.0), (0, 1, 0))
    s = 50.0
    plane = np.array([[-s, 0, -s, 1], [s, 0, -s, 1], [s, 0, s, 1], [-s, 0, s, 1]], np.float32)
    return (plane @ pv.T).astype(np.float32), [[0, 2, 1], [0, 3, 2]]


def test_a_vertex_behind_the_eye_covers_to_the_screens_edge():
    """Both rasters' boxes are the whole screen for a triangle with a
    vertex behind the eye, so coverage runs to every edge of the screen:
    the same pixels as with no box at all."""
    width, height = 256, 64
    clip, tris = _behind_the_eye(width, height)
    payload, ids, ts, setup = _gbuf_case(clip, tris, width, height)
    assert bool((setup.w_clip <= 1e-6).any(-1).all())
    np.testing.assert_array_equal(setup.pixel_box.numpy(), [[0, 0, width - 1, height - 1]] * 2)
    ch = raster_gbuf.rasterize_gbuffer_tiles_plain(payload, ids, ts, 0, width, height,
                                                   pass_class=0)
    img = raster.untile_image(ch["tri"], width // 128, height // 8, 128, 8, width, height)
    assert bool((img[-1] >= 0).all()) and bool((img[:, 0] >= 0).any())
    assert bool((img[:, -1] >= 0).any())
    loose = _gbuf_case(clip, tris, width, height, [-1e9, -1e9, 1e9, 1e9])[0]
    ref = raster_gbuf.rasterize_gbuffer_tiles_plain(loose, ids, ts, 0, width, height,
                                                    pass_class=0)
    assert torch.equal(ch["tri"], ref["tri"])
    bins = raster.bin_triangles_materialized(setup, width // 128, height // 8, 8, 64, 16)
    vis = raster_vis.rasterize(setup, bins, width, height, 128, 8)
    assert torch.equal(vis.tri_id, img)
