"""Port triangle setup, class-split binning and the G-buffer raster
(kernel 1's plain version) vs the JAX package.

Random triangles as in tests/test_gbuf_kernel.py (some crossing the
camera plane), at W=256, H=64 with the reference's 8x128 tiles. The
reference raster runs its Pallas kernel in interpret mode. Triangle ids
and material ids must be equal, depth within 1e-7, the interpolated
attributes within atol 1e-4 / rtol 1e-3 (the reference's own G-buffer
kernel pin), for pos_derivs and uv_channels on and off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmission_renderer_tpu.ops import raster as jraster
from transmission_renderer_tpu.ops import raster_pallas_gbuf as jgbuf
from transmission_renderer_tpu.scene.camera import look_at_rh, perspective_matrix_reversed
from transmission_renderer_tpu_torch.ops import raster, raster_gbuf

# torch runs single-threaded here: the suite runs in several worker
# processes at once, and oversubscribed OpenMP threads stall each other
torch.set_num_threads(1)

W, H = 256, 64
TIERS = ((8, 4096), (128, 512), (2048, 64), (0, 16))
K = 2


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed, n_v=60, n_t=60):
    rng = np.random.default_rng(seed)
    pv = perspective_matrix_reversed(W, H) @ look_at_rh(
        (0.0, 1.0, 5.0), (0.0, 1.0, 0.0), (0, 1, 0))
    pos = rng.uniform(-2, 2, (n_v, 3)).astype(np.float32)
    pos[:4, 2] = rng.uniform(4.0, 7.0, 4)  # near / behind the camera
    nrm = rng.normal(size=(n_v, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    uv = rng.uniform(0, 1, (n_v, 2)).astype(np.float32)
    tris = rng.integers(0, n_v, (n_t, 3))
    tris = tris[(tris[:, 0] != tris[:, 1]) & (tris[:, 1] != tris[:, 2])
                & (tris[:, 0] != tris[:, 2])].astype(np.int32)
    # both windings, so half the triangles survive the backface cull
    mat = rng.integers(0, 5, len(tris)).astype(np.int32)
    scale = rng.uniform(0.5, 2.0, len(tris)).astype(np.float32)
    cls = rng.integers(0, 2, len(tris)).astype(np.int32)
    enabled = rng.uniform(size=len(tris)) < 0.9
    ph = np.concatenate([pos, np.ones((n_v, 1), np.float32)], -1)
    clip = (ph @ pv.T).astype(np.float32)
    return dict(clip=clip, tris=tris, mat=mat, scale=scale, cls=cls,
                enabled=enabled, pos=pos, nrm=nrm, uv=uv)


def _ref_pipeline(d):
    setup = jraster.setup_triangles(jnp.asarray(d["clip"]), jnp.asarray(d["tris"]),
                                    jnp.asarray(d["enabled"]), W, H, 128, 8)
    bins = jraster.bin_triangles(
        setup, W // 128, H // 8, K, 1024, 16, materialize=False,
        class_flags=jnp.asarray(d["cls"]), num_classes=2, mid_tile_cap=128,
        max_mid_tris=512, tiers=TIERS)
    records = jgbuf.pack_gbuf_payload(
        setup, jnp.asarray(d["tris"]), jnp.asarray(d["mat"]),
        jnp.asarray(d["scale"]), jnp.asarray(d["pos"]), jnp.asarray(d["nrm"]),
        jnp.asarray(d["uv"]), jnp.asarray(d["cls"]))
    return setup, bins, records


def _port_pipeline(d):
    setup = raster.setup_triangles(_t(d["clip"]), _t(d["tris"]), _t(d["enabled"]),
                                   W, H, 128, 8)
    bins = raster.bin_triangles(setup, W // 128, H // 8, K, _t(d["cls"]), 2, TIERS)
    records = raster_gbuf.pack_gbuf_payload(
        setup, _t(d["tris"]), _t(d["mat"]), _t(d["scale"]), _t(d["pos"]),
        _t(d["nrm"]), _t(d["uv"]), _t(d["cls"]))
    return setup, bins, records


@pytest.mark.parametrize("seed", [5, 9])
def test_setup_triangles_exact(seed):
    d = _inputs(seed)
    ref, _, _ = _ref_pipeline(d)
    got, _, _ = _port_pipeline(d)
    for f in ("adj", "z_clip", "w_clip", "valid", "tile_bbox"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert int(got.valid.sum()) > 5


@pytest.mark.parametrize("seed", [5, 9])
def test_bin_triangles_exact(seed):
    """tile_start, sorted ids and tier demands exactly equal."""
    d = _inputs(seed)
    _, ref, ref_rec = _ref_pipeline(d)
    _, got, rec = _port_pipeline(d)
    np.testing.assert_array_equal(got.tile_start.numpy(), np.asarray(ref.tile_start))
    np.testing.assert_array_equal(got.sorted_tri_ids.numpy(),
                                  np.asarray(ref.sorted_tri_ids))
    assert got.tier_slots == ref.tier_slots
    assert [int(x) for x in got.tier_demands] == [int(x) for x in ref.tier_demands]
    assert int(got.big_tri_count) == int(ref.big_tri_count)
    assert int(got.max_bin_count) == int(ref.max_bin_count)
    np.testing.assert_array_equal(rec.numpy(), np.asarray(ref_rec))
    ref_rows, _ = jgbuf.gather_gbuf_payload(ref_rec, ref)
    rows, _ = raster_gbuf.gather_gbuf_payload(rec, got)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(ref_rows))


def _compare_channels(got: dict, ref: dict):
    assert set(got) == set(ref)
    for name, r in ref.items():
        a, r = got[name].numpy(), np.asarray(r)
        if name in ("tri", "material"):
            np.testing.assert_array_equal(a, r, err_msg=name)
        elif name == "depth":
            np.testing.assert_allclose(a, r, atol=1e-7, rtol=0, err_msg=name)
        else:
            np.testing.assert_allclose(a, r, atol=1e-4, rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("pass_class", [0, 1])
@pytest.mark.parametrize("pos_derivs,uv_channels", [
    (True, True), (False, True), (False, False)])
def test_plain_raster_matches_reference(pass_class, pos_derivs, uv_channels):
    """Full-frame raster vs rasterize_gbuffer_pallas(interpret=True)."""
    d = _inputs(5)
    _, ref_bins, ref_rec = _ref_pipeline(d)
    _, bins, rec = _port_pipeline(d)
    payload = jgbuf.gather_gbuf_payload(ref_rec, ref_bins)
    ids = jnp.arange((W // 128) * (H // 8), dtype=jnp.int32)
    ref = jgbuf.rasterize_gbuffer_tiles(
        payload, ids, ref_bins.tile_start, jnp.zeros((), jnp.int32), W, H,
        pass_class=pass_class, interpret=True, pos_derivs=pos_derivs,
        uv_channels=uv_channels)
    got = raster_gbuf.rasterize_gbuffer_tiles(
        raster_gbuf.gather_gbuf_payload(rec, bins), _t(ids), bins.tile_start, 0,
        W, H, pass_class=pass_class, pos_derivs=pos_derivs,
        uv_channels=uv_channels)
    _compare_channels(got, ref)
    assert int((got["tri"] >= 0).sum()) > 50
    if pass_class == 0 and pos_derivs and uv_channels:
        # and the assembled G-buffer, as the frame consumes it
        gref = jgbuf.rasterize_gbuffer_pallas(ref_rec, ref_bins, W, H, pass_class=0,
                                              interpret=True)
        ggot = raster_gbuf.rasterize_gbuffer_pallas(rec, bins, W, H, pass_class=0)
        for f in gref._fields:
            a, r = getattr(ggot, f).numpy(), np.asarray(getattr(gref, f))
            np.testing.assert_allclose(a, r, atol=1e-4, rtol=1e-3, err_msg=f)


@pytest.mark.parametrize("pass_class,peel", [(1, False), (None, True)])
def test_plain_raster_tile_subset_with_init_depth(pass_class, peel):
    """A tile worklist seeded with an existing depth (the transmissive
    pass raced against opaque depth) vs rasterize_gbuffer_tiles; and every
    class at once under a depth-peel bound (max_depth_tiles)."""
    d = _inputs(9)
    _, ref_bins, ref_rec = _ref_pipeline(d)
    _, bins, rec = _port_pipeline(d)
    rng = np.random.default_rng(1)
    # the busiest tiles of the pass (one repeated), in scrambled order
    ts = bins.tile_start.numpy()
    runs = ts[1::2] - ts[0:-1:2] if pass_class == 0 else ts[2::2] - ts[1:-1:2]
    busy = np.argsort(-runs, kind="stable")[:4].astype(np.int32)
    ids = np.array([busy[2], busy[0], busy[3], busy[2], busy[1]], np.int32)
    # seed / bound depths around the tiles' own front depths, so the race
    # both keeps and loses fragments
    front = raster_gbuf.rasterize_gbuffer_tiles(
        raster_gbuf.gather_gbuf_payload(rec, bins), _t(ids), bins.tile_start, 0,
        W, H, pass_class=pass_class)["depth"].numpy()
    shape = (len(ids), 8, 128)
    init = (front * rng.uniform(0.0, 1.2, shape)).astype(np.float32)
    maxd = (front * rng.uniform(0.9, 1.5, shape)).astype(np.float32) if peel else None
    ref = jgbuf.rasterize_gbuffer_tiles(
        jgbuf.gather_gbuf_payload(ref_rec, ref_bins), jnp.asarray(ids),
        ref_bins.tile_start, jnp.zeros((), jnp.int32), W, H,
        init_depth_tiles=jnp.asarray(init),
        max_depth_tiles=None if maxd is None else jnp.asarray(maxd),
        pass_class=pass_class, interpret=True)
    got = raster_gbuf.rasterize_gbuffer_tiles(
        raster_gbuf.gather_gbuf_payload(rec, bins), _t(ids), bins.tile_start, 0,
        W, H, init_depth_tiles=_t(init),
        max_depth_tiles=None if maxd is None else _t(maxd), pass_class=pass_class)
    _compare_channels(got, ref)
    assert int((got["tri"] >= 0).sum()) > 50


def test_tile_image_roundtrip():
    rng = np.random.default_rng(2)
    img = rng.uniform(size=(70, 200, 3)).astype(np.float32)
    ref = jraster.tile_image(jnp.asarray(img), 128, 8)
    got = raster.tile_image(_t(img), 128, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    back = raster.untile_image(got, 2, 9, 128, 8, 200, 70)
    np.testing.assert_array_equal(back.numpy(), img)


def test_dragon_binning_exact():
    """The small dragon at 256x64 through the frame's own setup/binning
    chain (vertex transform, cull, class flags, tier ladder)."""
    from transmission_renderer_tpu.config import (
        BUCKET_OPAQUE, BUCKET_TRANSMISSION, RenderConfig)
    from transmission_renderer_tpu.models.procedural import build_dragon_scene
    from transmission_renderer_tpu.ops import cull as jcull
    from transmission_renderer_tpu.render import make_frame_params
    from transmission_renderer_tpu.scene.camera import CameraRig
    from transmission_renderer_tpu.scene.types import Similarity, similarity_apply
    from transmission_renderer_tpu_torch import bridge
    from transmission_renderer_tpu_torch.ops import cull

    cfg = RenderConfig(width=W, height=H)
    scene, dl, flags = build_dragon_scene(stacks=24, sectors=48).finish_bundle()
    rig = CameraRig()
    rig.camera.position = np.array([0.0, 2.2, 1.5], np.float32)
    rig.camera.pitch = -0.25
    params = make_frame_params(cfg, rig.camera.view_matrix(), rig.camera.position,
                               rig.sun_dir())
    # reference chain, compiled as render_frame runs it (frame.py:984-1104):
    # the backface cull's determinant rounds as in the jitted frame
    @jax.jit
    def chain(scene, dl, params):
        inst_t = Similarity(*(a[dl.vtx_inst] for a in scene.inst_transform))
        world = similarity_apply(inst_t, scene.positions[dl.vtx_src])
        pos_h = jnp.concatenate([world, jnp.ones_like(world[:, :1])], -1)
        clip = pos_h @ params.proj_view.T
        vis = jcull.cull_instances(scene, params.view, params.frustum_x_xz,
                                   params.frustum_y_yz, cfg.z_near)
        mask = jcull.bucket_triangle_masks(dl.tri_inst, dl.tri_bucket, vis,
                                           (BUCKET_OPAQUE, BUCKET_TRANSMISSION))
        cls = (dl.tri_bucket == BUCKET_TRANSMISSION).astype(jnp.int32)
        setup = jraster.setup_triangles(clip, dl.tri_vtx, mask, W, H, 128, 8)
        return world, clip, jraster.bin_triangles(
            setup, 2, 8, cfg.pallas_tiles_per_tri, 2048, 32, materialize=False,
            class_flags=cls, num_classes=2, mid_tile_cap=128, max_mid_tris=512,
            tiers=cfg.pallas_tiers)

    world, clip, ref = chain(scene, dl, params)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    s, d_, p, _, _ = bridge.from_jax_arrays(as_np(scene), as_np(dl), as_np(params),
                                            _lights_np(), flags, device="cpu")
    # the port's clip from the reference's (matmul order may differ by an
    # ulp); everything downstream must then agree exactly
    clip_t = _t(clip)
    vis_t = cull.cull_instances(s, p.view, p.frustum_x_xz, p.frustum_y_yz, cfg.z_near)
    mask_t = cull.bucket_triangle_masks(d_.tri_inst, d_.tri_bucket, vis_t,
                                        (BUCKET_OPAQUE, BUCKET_TRANSMISSION))
    setup_t = raster.setup_triangles(clip_t, d_.tri_vtx, mask_t, W, H, 128, 8)
    got = raster.bin_triangles(setup_t, 2, 8, cfg.pallas_tiles_per_tri,
                               (d_.tri_bucket == BUCKET_TRANSMISSION).to(torch.int32),
                               2, cfg.pallas_tiers)
    np.testing.assert_array_equal(got.tile_start.numpy(), np.asarray(ref.tile_start))
    np.testing.assert_array_equal(got.sorted_tri_ids.numpy(),
                                  np.asarray(ref.sorted_tri_ids))
    assert [int(x) for x in got.tier_demands] == [int(x) for x in ref.tier_demands]
    # the port's own vertex transform agrees with the reference's to an ulp
    from transmission_renderer_tpu_torch.ops.cull import transform_vertices

    w_t, _, _, c_t, _ = transform_vertices(s, d_, p.proj_view)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(world), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(clip), rtol=1e-5, atol=1e-5)


def _lights_np():
    from transmission_renderer_tpu.pbr.lights import pack_lights, point_light

    return jax.tree_util.tree_map(
        np.asarray, pack_lights([point_light([0.0, 0.8, 0.0], [1, 0, 0], 5.0)]))


# ---------------------------------------------------------------------------
# the kernel's decomposition: (tile, segment) races merged by the
# (depth, -index) key, then one interpolation per pixel
# ---------------------------------------------------------------------------

def _scene_with(seed, n_v=60, n_t=60, duplicate=False):
    d = _inputs(seed, n_v, n_t)
    if duplicate:
        # every triangle twice, coplanar: equal depths, so the race ties
        # across segments (the copies carry other materials and scales)
        rng = np.random.default_rng(seed + 100)
        n = len(d["tris"])
        d["tris"] = np.concatenate([d["tris"], d["tris"]])
        d["mat"] = np.concatenate([d["mat"], rng.integers(5, 9, n).astype(np.int32)])
        d["scale"] = np.concatenate([d["scale"], d["scale"] * 2.0]).astype(np.float32)
        d["cls"] = np.concatenate([d["cls"], d["cls"]])
        d["enabled"] = np.concatenate([d["enabled"], d["enabled"]])
    _, bins, rec = _port_pipeline(d)
    return raster_gbuf.gather_gbuf_payload(rec, bins), bins.tile_start


def _segment_case(case):
    """(payload, tile ids, tile_start, keyword arguments) of one case."""
    all_ids = torch.arange((W // 128) * (H // 8), dtype=torch.int32)
    if case == "long_run":
        payload, ts = _scene_with(3, n_v=200, n_t=1000)
        return payload, all_ids, ts, {}
    payload, ts = _scene_with(9 if case == "duplicated" else 5,
                              duplicate=case == "duplicated")
    if case in ("random", "duplicated"):
        return payload, all_ids, ts, {}
    if case in ("class0", "class1"):
        return payload, all_ids, ts, {"pass_class": int(case[-1])}
    # a seed or a bound at exactly the tiles' own front depths on half the
    # pixels (a record there ties it and must lose), scaled elsewhere; a
    # repeated tile in scrambled order
    ids = torch.tensor([5, 2, 7, 5, 0, 12], dtype=torch.int32)
    front = raster_gbuf.rasterize_gbuffer_tiles(payload, ids, ts, 0, W, H)["depth"]
    rng = np.random.default_rng(4)
    half = torch.from_numpy(rng.uniform(size=front.shape) < 0.5)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, front.shape).astype(np.float32))
    bound = torch.where(half, front, front * scale).contiguous()
    if case == "seeded":
        return payload, ids, ts, {"init_depth_tiles": bound, "pass_class": 1}
    return payload, ids, ts, {"max_depth_tiles": bound}


_SEQUENTIAL = {}


@pytest.mark.parametrize("segment", [1, 3, 32])
@pytest.mark.parametrize("case", ["random", "duplicated", "seeded", "peel", "class0",
                                  "class1", "long_run"])
def test_segmented_race_equals_sequential(case, segment):
    """Every channel of the segmented race (the kernel's decomposition)
    equals the sequential walk's bit for bit."""
    payload, ids, ts, kw = _segment_case(case)
    if case not in _SEQUENTIAL:
        _SEQUENTIAL[case] = raster_gbuf.rasterize_gbuffer_tiles_plain(
            payload, ids, ts, 0, W, H, **kw)
    ref = _SEQUENTIAL[case]
    got = raster_gbuf.rasterize_gbuffer_tiles_plain(payload, ids, ts, 0, W, H,
                                                     segment=segment, **kw)
    assert set(got) == set(ref)
    for name, r in ref.items():
        assert got[name].dtype == r.dtype, name
        assert torch.equal(got[name], r), name
    assert int((ref["tri"] >= 0).sum()) > 50
    nc = (ts.shape[0] - 1) // ((W // 128) * (H // 8))
    _, count = raster_gbuf._tile_runs(ts, ids, nc, kw.get("pass_class"))
    if case == "long_run":
        assert int(count.max()) >= 300  # a run of several hundred records
    if case == "duplicated":
        # a pixel won by the first copy of a triangle: its twin ties it
        assert (ref["material"] < 5)[ref["tri"] >= 0].any()


@pytest.mark.parametrize("segment", [1, 3, 32])
def test_work_list_covers_every_record_once(segment):
    """Every (tile slot, record) pair of the runs is in exactly one item,
    items hold 1..segment records, the runs of most segments come first,
    and the compact form the kernel reads (binary search of the running
    segment count over the non-empty slots) names the same items."""
    rng = np.random.default_rng(segment)
    count = rng.integers(0, 100, 40)
    count[::7] = 0
    count[3] = 700
    start = rng.integers(0, 5000, 40)  # runs may overlap (repeated tiles)
    start_t, count_t = torch.from_numpy(start), torch.from_numpy(count)
    slot, begin, end = (a.numpy() for a in raster_gbuf.work_items(start_t, count_t, segment))
    n = end - begin
    assert ((n >= 1) & (n <= segment)).all()
    pairs = sorted((int(s), int(r)) for s, b, e in zip(slot, begin, end) for r in range(b, e))
    assert pairs == sorted((k, int(start[k]) + j) for k in range(40) for j in range(count[k]))
    # most segments first (the top bucket of the kernel's plan holds all
    # the longer runs)
    bucket = np.minimum(-(-count[slot] // segment), raster_gbuf.PLAN_BUCKETS - 1)
    assert (np.diff(bucket) <= 0).all()
    order, seg_cum = (a.numpy() for a in raster_gbuf.gbuf_work_list(count_t, segment))
    assert len(order) == int((count > 0).sum())
    assert seg_cum[-1] == len(slot)
    for i in range(len(slot)):
        p = int(np.searchsorted(seg_cum, i, side="right"))
        j = i - (seg_cum[p - 1] if p else 0)
        assert (order[p], start[order[p]] + j * segment) == (slot[i], begin[i])


@pytest.mark.parametrize("case", ["random", "class1", "seeded"])
def test_covered_pairs_counts_the_covering_records(case):
    """covered_pairs (the pairs kernel 1's bound charges the depth test
    for) equals a numpy float32 count: per listed tile, per record of its
    run in the pass's class, the pixels whose three edge functions pass
    the top-left rule; a record covers few of a tile's pixels."""
    payload, ids, ts, kw = _segment_case(case)
    pc = kw.get("pass_class")
    got = raster_gbuf.covered_pairs(payload, ids, ts, W, H, pass_class=pc)
    recs = payload[0].reshape(-1, raster_gbuf.REC_F32).numpy()
    start, count = raster_gbuf._tile_runs(ts, ids, (ts.shape[0] - 1) // ((W // 128) * (H // 8)),
                                          pc)
    nx, ny = (a.numpy() for a in raster_gbuf._pixel_ndc(ids, W, H))

    def covered(e, a, b):
        return (e > 0) | ((e == 0) & ((a > 0) | ((a == 0) & (b > 0))))

    want = pairs = 0
    for k in range(len(ids)):
        for r in recs[int(start[k]) : int(start[k] + count[k])]:
            if pc is not None and (int(r[15]) >> raster_gbuf.CLASS_SHIFT) != pc:
                continue
            pairs += nx[k].size
            cov = np.ones(nx[k].shape, bool)
            for j in range(3):
                a, b, c = r[3 * j : 3 * j + 3]
                cov &= covered(a * nx[k] + b * ny[k] + c, a, b)
            want += int(cov.sum())
    assert got == want
    assert 0 < want < 0.5 * pairs


def test_segmented_race_on_an_empty_tile_list():
    payload, ts = _scene_with(5)
    ids = torch.zeros(0, dtype=torch.int32)
    got = raster_gbuf.rasterize_gbuffer_tiles_plain(payload, ids, ts, 0, W, H, segment=3)
    assert got["depth"].shape == (0, 8, 128)
