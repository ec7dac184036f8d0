"""Port materialised binning and the visibility raster (kernel 6's plain
version, in both walk orders) vs the JAX package.

The scenes of tests/test_raster_pallas.py at W=256, H=64 with 8x128
tiles: random triangles, an init-depth seed, a floor plane whose
full-screen bbox sends it to the big list, and class-filtered passes
over class-flagged records. The kernel-6 order is held against
``rasterize_pallas(interpret=True)``, the XLA-raster order against
``ops/raster.py::rasterize``, also with 32x8 tiles and with bins cut
below a tile's count (the triangles the reference drops must be the
ones the port drops). Tolerances are test_raster_pallas.py's: triangle
ids equal, depth within 1e-7, barycentrics within 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmission_renderer_tpu.ops import raster as jraster
from transmission_renderer_tpu.ops import raster_pallas as jpallas
from transmission_renderer_tpu.scene.camera import look_at_rh, perspective_matrix_reversed
from transmission_renderer_tpu_torch import bridge
from transmission_renderer_tpu_torch.ops import raster, raster_gbuf, raster_vis

# torch runs single-threaded here: the suite runs in several worker
# processes at once, and oversubscribed OpenMP threads stall each other
torch.set_num_threads(1)

W, H = 256, 64


def _t(a):
    return torch.from_numpy(np.array(a))


def _project(positions, pv):
    ph = np.concatenate([positions, np.ones((len(positions), 1), np.float32)], -1)
    return (ph @ pv.T).astype(np.float32)


def _random_scene(seed, n_tris=25):
    """test_raster_pallas.py's scene: large triangles over 30 points."""
    rng = np.random.default_rng(seed)
    pv = perspective_matrix_reversed(W, H) @ look_at_rh(
        (0.0, 1.0, 5.0), (0.0, 1.0, 0.0), (0, 1, 0))
    pts = rng.uniform(-2, 2, (30, 3)).astype(np.float32)
    tris = rng.integers(0, 30, (n_tris, 3))
    tris = tris[(tris[:, 0] != tris[:, 1]) & (tris[:, 1] != tris[:, 2])
                & (tris[:, 0] != tris[:, 2])]
    return _project(pts, pv), tris.astype(np.int32)


def _small_scene(seed, n_tris=160):
    """Many small overlapping triangles (crowded bins)."""
    rng = np.random.default_rng(seed)
    pv = perspective_matrix_reversed(W, H) @ look_at_rh(
        (0.0, 1.0, 5.0), (0.0, 1.0, 0.0), (0, 1, 0))
    centres = rng.uniform(-1.5, 1.5, (n_tris, 1, 3)) * [1.5, 0.4, 1.0] + [0.0, 1.0, 0.0]
    pts = (centres + rng.uniform(-0.3, 0.3, (n_tris, 3, 3))).reshape(-1, 3)
    tris = np.arange(3 * n_tris, dtype=np.int32).reshape(n_tris, 3)
    return _project(pts.astype(np.float32), pv), tris


def _big_scene():
    """A floor plane under a camera close to it (a vertex behind the
    camera gives its triangles full-screen bboxes) and random triangles."""
    pv = perspective_matrix_reversed(W, H) @ look_at_rh(
        (0.0, 1.0, 0.0), (0.0, 0.5, -3.0), (0, 1, 0))
    s = 50.0
    plane = np.array([[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]], np.float32)
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1.5, 1.5, (20, 3)).astype(np.float32) + [0.0, 0.8, -3.0]
    tris = rng.integers(0, 20, (30, 3)) + 4
    tris = tris[(tris[:, 0] != tris[:, 1]) & (tris[:, 1] != tris[:, 2])
                & (tris[:, 0] != tris[:, 2])]
    tris = np.concatenate([[[0, 2, 1], [0, 3, 2]], tris]).astype(np.int32)
    return _project(np.concatenate([plane, pts]), pv), tris


SCENES = {"random": lambda: _random_scene(0), "init": lambda: _random_scene(3),
          "big": _big_scene, "dense": lambda: _small_scene(7)}


def _setups(clip, tris, tw=128, th=8):
    ref = jraster.setup_triangles(jnp.asarray(clip), jnp.asarray(tris),
                                  jnp.ones(len(tris), bool), W, H, tw, th)
    got = raster.setup_triangles(_t(clip), _t(tris), torch.ones(len(tris), dtype=torch.bool),
                                 W, H, tw, th)
    return ref, got


def _init_depth(name):
    if name != "init":
        return None
    init = np.zeros((H, W), np.float32)
    init[:, : W // 4] = 0.9  # those pixels must stay empty
    # the rest races against a ramp through the scene's own depths
    init[:, W // 4 :] = np.linspace(0.0, 4e-3, W - W // 4, dtype=np.float32)
    return init


def _compare(got: raster.VisibilityBuffer, ref):
    tri = np.asarray(ref.tri_id)
    np.testing.assert_array_equal(got.tri_id.numpy(), tri)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(ref.depth), atol=1e-7, rtol=0)
    np.testing.assert_allclose(got.bary.numpy(), np.asarray(ref.bary), atol=1e-6, rtol=0)
    assert (tri >= 0).sum() > 100


def _bins(ref_setup, setup, tw, th, k=8, cap=64, nbig=16):
    tx, ty = -(-W // tw), -(-H // th)
    return (jraster.bin_triangles(ref_setup, tx, ty, k, cap, nbig),
            raster.bin_triangles_materialized(setup, tx, ty, k, cap, nbig))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_materialized_binning_exact(name):
    """Per-tile lists, capped counts, the big list and its count, the raw
    maximum: equal to the reference's ``materialize=True`` binning."""
    ref_setup, setup = _setups(*SCENES[name]())
    ref, got = _bins(ref_setup, setup, 128, 8, k=4, cap=6, nbig=1)
    for f in ("tile_tri_ids", "tile_tri_count", "big_tri_ids", "big_tri_count",
              "tile_start", "sorted_tri_ids", "max_bin_count"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_kernel6_order_matches_rasterize_pallas(name):
    clip, tris = SCENES[name]()
    ref_setup, setup = _setups(clip, tris)
    ref_bins, bins = _bins(ref_setup, setup, 128, 8)
    init = _init_depth(name)
    ref = jpallas.rasterize_pallas(ref_setup, ref_bins, W, H, interpret=True,
                                   init_depth=None if init is None else jnp.asarray(init))
    got = raster_vis.rasterize_pallas(setup, bins, W, H,
                                      init_depth=None if init is None else _t(init))
    _compare(got, ref)
    if name == "big":  # the floor plane's two triangles ride the big list
        assert bins.big_tri_ids[:2].tolist() == [0, 1]


@pytest.mark.parametrize("tiles", [(128, 8), (32, 8)])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_xla_order_matches_rasterize(name, tiles):
    clip, tris = SCENES[name]()
    tw, th = tiles
    ref_setup, setup = _setups(clip, tris, tw, th)
    ref_bins, bins = _bins(ref_setup, setup, tw, th)
    init = _init_depth(name)
    ref = jraster.rasterize(ref_setup, ref_bins, W, H, tw, th,
                            init_depth=None if init is None else jnp.asarray(init))
    got = raster_vis.rasterize(setup, bins, W, H, tw, th,
                               init_depth=None if init is None else _t(init))
    _compare(got, ref)


@pytest.mark.parametrize("pass_class", [0, 1])
def test_kernel6_order_pass_class(pass_class):
    """Class-flagged records with a pass filter, as rasterize_pallas runs
    them with an injected payload."""
    clip, tris = SCENES["dense"]()
    ref_setup, setup = _setups(clip, tris)
    ref_bins, bins = _bins(ref_setup, setup, 128, 8)
    cls = np.random.default_rng(5).integers(0, 2, len(tris)).astype(np.int32)
    ref_pay = jpallas.gather_bin_payload(ref_setup, ref_bins, jnp.asarray(cls))
    pay = raster_vis.gather_bin_payload(setup, bins, _t(cls))
    ref_rec = np.asarray(ref_pay[0]).reshape(-1, 16)[: pay[0].shape[0]]
    np.testing.assert_array_equal(pay[0].numpy(), ref_rec)
    ref = jpallas.rasterize_pallas(ref_setup, ref_bins, W, H, interpret=True,
                                   pass_class=pass_class, payload=ref_pay)
    got = raster_vis.rasterize_pallas(setup, bins, W, H, pass_class=pass_class, payload=pay)
    _compare(got, ref)


def test_xla_order_drops_what_the_reference_drops():
    """Bins cut below the busiest tiles' counts: the XLA order walks the
    first max_tris_per_tile triangles of each run, so it loses exactly the
    reference's, and the kernel-6 order (uncut runs) keeps them."""
    clip, tris = SCENES["dense"]()
    ref_setup, setup = _setups(clip, tris)
    ref_bins, bins = _bins(ref_setup, setup, 128, 8, cap=10)
    assert int(bins.max_bin_count) > 10
    ref = jraster.rasterize(ref_setup, ref_bins, W, H, 128, 8)
    got = raster_vis.rasterize(setup, bins, W, H, 128, 8)
    _compare(got, ref)
    full = raster_vis.rasterize_pallas(setup, bins, W, H)
    assert int((full.tri_id != got.tri_id).sum()) > 50


def test_bridge_carries_vis_buffer_and_bins():
    """bridge.vis_buffer / bridge.tile_bins give the reference's arrays
    back as port tensors, and the port rasterises the bridged bins."""
    clip, tris = SCENES["big"]()
    ref_setup, setup = _setups(clip, tris)
    ref_bins, _ = _bins(ref_setup, setup, 128, 8)
    ref = jraster.rasterize(ref_setup, ref_bins, W, H, 128, 8)
    vis = bridge.vis_buffer(ref, device="cpu")
    bins = bridge.tile_bins(ref_bins, device="cpu")
    assert bins.tile_tri_ids.dtype == torch.int32
    _compare(vis, ref)
    _compare(raster_vis.rasterize(setup, bins, W, H, 128, 8), ref)


# ---------------------------------------------------------------------------
# the kernel's decomposition: (tile, list segment) races merged by the
# (depth, -id) key, then one resolve per pixel
# ---------------------------------------------------------------------------

def _port_bins(clip, tris, cls=None):
    """Port-only setup, materialised bins (8x128 tiles, big list of up to
    16) and payload of a scene."""
    setup = raster.setup_triangles(_t(clip), _t(tris), torch.ones(len(tris), dtype=torch.bool),
                                   W, H, 128, 8)
    bins = raster.bin_triangles_materialized(setup, W // 128, H // 8, 8, 4096, 16)
    return setup, bins, raster_vis.gather_bin_payload(
        setup, bins, None if cls is None else _t(cls))


def _call(payload, bins):
    """raster_vis arguments over every tile: its whole binned run, and the
    big list."""
    ids = torch.arange((W // 128) * (H // 8), dtype=torch.int32)
    tid = ids.long()
    return (payload, ids, bins.tile_start[tid].contiguous(), bins.tile_tri_count[tid].contiguous(),
            bins.big_tri_count.to(torch.int32).reshape(1))


def _crowd(seed, n_tris):
    """Small triangles crowded in front of a camera close to them (most
    tiles' runs hold dozens to hundreds of records)."""
    rng = np.random.default_rng(seed)
    pv = perspective_matrix_reversed(W, H) @ look_at_rh(
        (0.0, 1.0, 0.0), (0.0, 0.5, -3.0), (0, 1, 0))
    centres = rng.uniform(-1.5, 1.5, (n_tris, 1, 3)) * [1.5, 0.4, 1.0] + [0.0, 0.9, -3.0]
    pts = (centres + rng.uniform(-0.3, 0.3, (n_tris, 3, 3))).reshape(-1, 3)
    tris = np.arange(3 * n_tris, dtype=np.int32).reshape(-1, 3)
    return _project(pts.astype(np.float32), pv), tris


def _twins(clip, tris):
    """Every triangle twice (coplanar copies, ids t and t + n)."""
    return clip, np.concatenate([tris, tris])


def _regathered(ext, args):
    """The call's lists regathered from modified rows by triangle id."""
    payload, ids, start, count, big_count = args
    recs, big, _ = payload
    rid = lambda r: torch.where(r[:, 15] < 0, ext.shape[0] - 1,  # noqa: E731
                                r[:, 15].to(torch.int64) & (raster_vis.CLASS_BIT - 1))
    return (ext[rid(recs)].contiguous(), ext[rid(big)].contiguous(), ext), ids, start, count, \
        big_count


def _decomposition_case(case):
    """(raster_vis arguments, keyword arguments) of one case."""
    if case == "long_run":
        _, bins, payload = _port_bins(*_crowd(8, 2000))
        return _call(payload, bins), {}
    if case in ("twins", "neg_zero"):
        _, bins, payload = _port_bins(*_twins(*_crowd(7, 150)))
        args = _call(payload, bins)
        if case == "twins":
            return args, {}
        # the first 40 twin pairs at depth -0 and +0 on the same pixels
        # (z all -0 against all +0), raced from a seed of -1 so that they
        # can win: -0 and +0 tie under the float compare
        ext = payload[2].clone()
        n = (ext.shape[0] - 1) // 2
        ext[:40, 9:12] = -0.0
        ext[n : n + 40, 9:12] = 0.0
        seed = torch.full((args[1].numel(), 8, 128), -1.0)
        return _regathered(ext, args), {"init_depth_tiles": seed}
    if case == "big_vs_run":
        # the floor's two triangles in every tile's run, their coplanar
        # copies (larger ids) as the big list: kernel-6 order walks the
        # copies first and keeps them on the ties, XLA order keeps the
        # smaller ids
        clip, tris = _big_scene()
        setup, bins, payload = _port_bins(clip, np.concatenate([tris, tris[:2]]))
        payload, ids, start, count, _ = _call(payload, bins)
        t = len(tris)
        lists = [torch.cat([payload[0][s : s + c // 2], payload[2][:2],
                            payload[0][s + c // 2 : s + c]])
                 for s, c in zip(start.tolist(), count.tolist())]
        count = torch.tensor([len(r) for r in lists], dtype=torch.int32)
        return ((torch.cat(lists), payload[2][[t, t + 1]].contiguous(), payload[2]), ids,
                (torch.cumsum(count, 0) - count).to(torch.int32), count,
                torch.tensor([2], dtype=torch.int32)), {}
    if case in ("class0", "class1"):
        clip, tris = _crowd(7, 150)
        cls = np.random.default_rng(5).integers(0, 2, len(tris)).astype(np.int32)
        _, bins, payload = _port_bins(clip, tris, cls)
        return _call(payload, bins), {"pass_class": int(case[-1])}
    scene = {"random": SCENES["random"], "dense": lambda: _crowd(7, 150),
             "seeded": _big_scene}[case]
    _, bins, payload = _port_bins(*scene())
    args = _call(payload, bins)
    if case != "seeded":
        return args, {}
    # a seed at exactly the front depths on half the pixels (a record
    # there ties it and must lose), scaled elsewhere
    front = raster_vis.raster_vis_plain(*args, W, H, 128, 8)[1]
    rng = np.random.default_rng(4)
    half = torch.from_numpy(rng.uniform(size=front.shape) < 0.5)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, front.shape).astype(np.float32))
    return args, {"init_depth_tiles": torch.where(half, front, front * scale).contiguous()}


_VIS_SEQUENTIAL = {}


def _bits(t):
    return t.view(torch.int32) if t.is_floating_point() else t


@pytest.mark.parametrize("xla_order", [True, False])
@pytest.mark.parametrize("segment", [1, 3, 32])
@pytest.mark.parametrize("case", ["random", "dense", "twins", "big_vs_run", "seeded",
                                  "neg_zero", "class0", "class1", "long_run"])
def test_segmented_race_equals_sequential(case, segment, xla_order):
    """tri, depth, b1 and b2 of the segmented race (the kernel's
    decomposition) equal the sequential walk's bit for bit, in both walk
    orders: exact depth ties inside a run, across segments and between the
    big list and the run, seeds at exactly a record's depth, records at -0
    and +0 depth, class-filtered passes and a run of several hundred
    records."""
    args, kw = _decomposition_case(case)
    key = (case, xla_order)
    if key not in _VIS_SEQUENTIAL:
        _VIS_SEQUENTIAL[key] = raster_vis.raster_vis_plain(*args, W, H, 128, 8,
                                                           xla_order=xla_order, **kw)
    ref = _VIS_SEQUENTIAL[key]
    got = raster_vis.raster_vis_plain(*args, W, H, 128, 8, xla_order=xla_order,
                                      segment=segment, **kw)
    for name, g, r in zip(("tri", "depth", "b1", "b2"), got, ref):
        assert g.dtype == r.dtype, name
        assert torch.equal(_bits(g), _bits(r)), name
    assert int((ref[0] >= 0).sum()) > 500
    if case == "long_run":
        assert int(args[3].max()) >= 300
    if case == "big_vs_run" and segment == 1:
        other = raster_vis.raster_vis_plain(*args, W, H, 128, 8, xla_order=not xla_order)
        assert bool((other[0] != ref[0]).any())  # the orders keep different triangles
    if case == "neg_zero":
        assert bool((ref[1].view(torch.int32) == -2**31).any())  # a winner at -0


def test_vis_work_list_walks_every_record_once_per_tile():
    """Kernel 6's work items over each tile's list (the big list, then its
    run): every big record and every run record of a tile in exactly one
    item of that tile, items of 1..SEG records, the lists of most segments
    first."""
    rng = np.random.default_rng(1)
    count = torch.from_numpy(rng.integers(0, 300, 30).astype(np.int32))
    count[::5] = 0
    count[4] = 2048
    start = torch.from_numpy(rng.integers(0, 9000, 30).astype(np.int32))
    big_count = torch.tensor([5], dtype=torch.int32)
    lengths = raster_vis.list_lengths(count, big_count)
    slot, begin, end = raster_gbuf.work_items(torch.zeros_like(lengths), lengths,
                                              raster_vis.SEG)
    n = end - begin
    assert bool(((n >= 1) & (n <= raster_vis.SEG)).all())
    walked = {}
    for s, b, e in zip(slot.tolist(), begin.tolist(), end.tolist()):
        for v in range(b, e):
            src = ("big", v) if v < 5 else ("run", int(start[s]) + v - 5)
            walked.setdefault(s, []).append(src)
    for k in range(30):
        want = [("big", j) for j in range(5)] + [("run", int(start[k]) + j)
                                                  for j in range(int(count[k]))]
        assert sorted(walked[k]) == sorted(want)
    nseg = -(-lengths[slot] // raster_vis.SEG)
    assert bool((torch.diff(torch.clamp(nseg, max=raster_gbuf.PLAN_BUCKETS - 1)) <= 0).all())


def test_vis_covered_pairs_counts_the_covering_records():
    """covered_pairs (the pairs whose depth test kernel 6's bound counts)
    equals a brute-force numpy count on both raster calls of a 128x72
    visibility-buffer frame of the dragon: per tile, per record of its
    list (the big list and its run), the pixels whose three edge
    functions, contracted as the kernel computes them, pass the top-left
    rule."""
    from transmission_renderer_tpu_torch.models.procedural import build_dragon_scene
    from transmission_renderer_tpu_torch.pbr.lights import pack_lights, point_light
    from transmission_renderer_tpu_torch.render.frame import make_frame_params, render_frame
    from transmission_renderer_tpu_torch.scene.camera import CameraRig
    from transmission_renderer_tpu_torch.config import RenderConfig

    cfg = RenderConfig(width=128, height=72, use_pallas_raster=False)
    scene, dl, flags = build_dragon_scene(stacks=24, sectors=48).finish_bundle(device="cpu")
    rig = CameraRig()
    rig.camera.position = np.array([0.0, 2.2, 1.5], np.float32)
    rig.camera.pitch = -0.25
    params = make_frame_params(cfg, rig.camera.view_matrix(), rig.camera.position,
                               rig.sun_dir(), device="cpu")
    lights = pack_lights([point_light([0.0, 0.8, 0.0], [1, 0, 0], 5.0)], device="cpu")
    raster_vis.KERNEL.recorder = []
    try:
        render_frame(scene, dl, params, lights, cfg, flags=flags)
        calls = raster_vis.KERNEL.recorder
    finally:
        raster_vis.KERNEL.recorder = None
    assert len(calls) == 2
    for args, kw in calls:
        payload, ids, start, count, big_count, w, h, tw, th = args
        got = raster_vis.covered_pairs(*args, pass_class=kw.get("pass_class"))
        recs, big = payload[0].numpy(), payload[1].numpy()
        nbig = int(big_count[0])
        want = pairs = 0
        for k, tile in enumerate(ids.tolist()):
            tx, ty = tile % -(-w // tw), tile // -(-w // tw)
            nx = ((np.float32(tx * tw) + np.arange(tw, dtype=np.float32)) + np.float32(0.5)) \
                * np.float32(2.0 / w) - np.float32(1.0)
            ny = ((np.float32(ty * th) + np.arange(th, dtype=np.float32)) + np.float32(0.5)) \
                * np.float32(2.0 / h) - np.float32(1.0)
            nx, ny = np.broadcast_to(nx[None], (th, tw)), np.broadcast_to(ny[:, None], (th, tw))
            lst = np.concatenate([big[:nbig], recs[int(start[k]) : int(start[k] + count[k])]])
            for r in lst:
                if int(r[15]) < 0:
                    continue
                pairs += nx.size
                cov = np.ones(nx.shape, bool)
                for j in range(3):
                    a, b, c = r[3 * j : 3 * j + 3]
                    e = (np.float64(a) * nx.astype(np.float64)
                         + (b * ny).astype(np.float64)).astype(np.float32) + c
                    cov &= (e > 0) | ((e == 0) & ((a > 0) | ((a == 0) & (b > 0))))
                want += int(cov.sum())
        assert got == want
        assert 0 < want < 0.5 * pairs
