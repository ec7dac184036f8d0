"""The port's CUDA kernels vs their plain PyTorch versions, on the card,
at small shapes: one frame of each scene without ray-traced shadows,
with them, and with them traced at half resolution (kernel 5, and kernel
3 reading shadow factors, upsampled ones in the last); kernel 5 alone on
a small mesh, also with half the rays dead; kernel 1 alone on runs of
several hundred records with ties across segments, a seeded pass and a
depth-peel bound, and with a big list walked before the runs; kernel 6 (the visibility raster) in both walk
orders on random scenes, and the visibility-buffer frame of each scene;
the closest-hit, alpha-tested walk of the AS-debug view on the stress
scene and on a two-class atlas with a bundle layer's alpha test (with
dead rays), and the CLI's frame and AS-debug view on the card; kernel 2
bit for bit against its plain version (its trilinear tap is
atlas_tap.cuh's, shared with kernel 6's alpha form); kernel 6's alpha
form and its checked form on the stress scene's visibility-buffer frame
at 256x144 (bit for bit, the checked frame silent and equal, injected
out-of-range indices reported through the error word).
Marked ``cuda``: on a host without a CUDA device they skip (the check
runs inside the fixture, never at import).

Run on a machine with the card (which has no JAX, so skip the suite's
conftest.py, which imports it):
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The full-size check of the same kernels is chip_smoke.py."""

import numpy as np
import pytest
import torch

from transmission_renderer_tpu_torch.config import RenderConfig
from transmission_renderer_tpu_torch.pbr.lights import spot_light

# torch runs single-threaded here: the suite runs in several worker
# processes at once, and oversubscribed OpenMP threads stall each other
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


def _dragon():
    from transmission_renderer_tpu_torch.models.procedural import build_dragon_scene

    return build_dragon_scene(stacks=40, sectors=80)


def _textured():
    """Paths the flagship does not take: a 4-layer texture bundle with a
    normal map and emission beside a single-layer checker (a two-class
    atlas), lit by a spot light too."""
    from transmission_renderer_tpu_torch.config import BUCKET_OPAQUE
    from transmission_renderer_tpu_torch.models.procedural import (
        checkerboard_texture, make_plane_mesh, make_sphere_mesh)
    from transmission_renderer_tpu_torch.scene.builder import SceneBuilder

    rng = np.random.default_rng(3)
    b = SceneBuilder()
    checker = b.add_texture(checkerboard_texture(64, 8), srgb=True)
    layers = [rng.integers(0, 256, (64, 64, 4)).astype(np.uint8) for _ in range(4)]
    layers[2][..., 2] = 255  # normal map: tangent-space z up
    refs = b.add_texture_bundle(list(zip(layers, (True, False, False, True))))
    floor = b.add_material(tex_diffuse=checker, roughness_factor=0.8)
    obj = b.add_material(tex_diffuse=refs[0], tex_metallic_roughness=refs[1],
                         tex_normal_map=refs[2], tex_emissive=refs[3],
                         emissive_factor=(0.5, 0.5, 0.5), metallic_factor=1.0)
    b.add_instance(b.add_primitive(*make_plane_mesh(6.0), bucket=BUCKET_OPAQUE), floor)
    b.add_instance(b.add_primitive(*make_sphere_mesh(16, 32), bucket=BUCKET_OPAQUE),
                   obj, translation=(0.0, 1.2, -3.5))
    return b


SCENES = {"dragon": _dragon, "textured": _textured}


def _handles():
    from transmission_renderer_tpu_torch.ops import bvh_packet, raster_gbuf, tap_finish
    from transmission_renderer_tpu_torch.render import shade_kernel

    return (raster_gbuf.KERNEL, tap_finish.TAP_KERNEL, shade_kernel.KERNEL,
            tap_finish.FETCH_KERNEL, bvh_packet.KERNEL)


RT_MODES = {0: "", 1: "-rt", 2: "-rt-half"}  # off, full-res, half_res_shadow_rays


@pytest.fixture(scope="module", params=[(s, rt) for s in sorted(SCENES) for rt in RT_MODES],
                ids=lambda p: p[0] + RT_MODES[p[1]])
def captured(request):
    """One small frame of a scene on the card, every kernel call recorded;
    ``rt`` 2 traces the opaque pass's shadow rays at half resolution, so
    the opaque shade reads upsampled (fractional) factors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels build with nvcc for sm_90a)")
    from transmission_renderer_tpu_torch.pbr.lights import pack_lights, point_light
    from transmission_renderer_tpu_torch.render import shade_kernel
    from transmission_renderer_tpu_torch.render.frame import make_frame_params, render_frame
    from transmission_renderer_tpu_torch.scene.camera import CameraRig

    dev = torch.device("cuda")
    name, rt = request.param
    builder = SCENES[name]()
    scene, dl, flags = builder.finish_bundle(device=dev)
    cfg = RenderConfig(width=256, height=144, sparse_raster_tile_floor=1,
                       ray_traced_shadows=rt > 0, half_res_shadow_rays=rt == 2)
    rig = CameraRig()
    rig.camera.position = np.array([0.0, 2.2, 1.5], np.float32)
    rig.camera.pitch = -0.25
    params = make_frame_params(cfg, rig.camera.view_matrix(), rig.camera.position,
                               rig.sun_dir(), device=dev)
    lights = pack_lights([
        point_light([0.0, 0.8, 0.0], [1, 0, 0], 5.0),
        point_light([8.0, 0.8, 0.0], [0, 1, 0], 10.0),
        spot_light([-1.0, 2.5, -3.0], [0.3, 0.4, 1.0], 14.0, [0.3, -1.0, -0.2],
                    0.3, 0.7),
    ], device=dev)
    bvh = builder.build_rt_bvh(device=dev) if rt else None
    handles = _handles()
    for h in handles:
        h.recorder = []
        h.launches = 0
    img = render_frame(scene, dl, params, lights, cfg, flags=flags, bvh=bvh)
    torch.cuda.synchronize()
    out = {h.name: (h.recorder, h.launches) for h in handles}
    for h in handles:
        h.recorder = None
    return request.param, img, out


def test_frame_launches_every_kernel(captured):
    (name, rt), img, out = captured
    glass = name == "dragon"  # the only scene with a transmissive pass
    assert {n: launches for n, (_, launches) in out.items()} == {
        "raster_gbuf": 1 + glass, "tap_finish": 1, "shade": 1 + glass,
        "transmission_fetch": int(glass), "bvh_occlusion": (rt > 0) * (1 + glass)}
    assert bool(torch.isfinite(img).all())


@pytest.mark.parametrize("name", ["raster_gbuf", "tap_finish", "shade",
                                  "transmission_fetch", "bvh_occlusion"])
def test_kernel_matches_plain(captured, name):
    """Each recorded call through the kernel and the plain version, with
    chip_smoke.py's tolerances: the raster's channels equal bit for bit
    (tri, material and every float plane); tap and fetch 1e-6; shade 1e-5 on
    all but 0.05% of the pixels (with the shadow factors in the -rt
    frames, upsampled in the -rt-half ones); the occlusion hit set exact."""
    handle = {h.name: h for h in _handles()}[name]
    (scene, rt), _, out = captured
    calls, _ = out[name]
    if not calls:
        assert (name == "transmission_fetch" and scene != "dragon"
                or name == "bvh_occlusion" and not rt)
    if name == "shade" and rt:
        assert all(c[0][0].sun_f is not None and c[0][0].light_f is not None for c in calls)
        if rt == 2:  # the opaque shade reads the 2x-upsampled factors
            sun_f = calls[0][0][0].sun_f
            assert bool(((sun_f > 0.0) & (sun_f < 1.0)).any())
    for call in calls:
        _check_against_plain(handle, call)


def test_tap_finish_bit_equal_to_plain(captured):
    """Kernel 2 (its trilinear tap now atlas_tap.cuh's, shared with kernel
    6's alpha form) equals its plain version bit for bit."""
    from transmission_renderer_tpu_torch.ops import tap_finish

    _, _, out = captured
    calls, _ = out["tap_finish"]
    assert calls
    for call in calls:
        got = tap_finish.TAP_KERNEL.replay(call, True)
        ref = tap_finish.TAP_KERNEL.replay(call, False)
        for g, r in zip(got, ref):
            assert torch.equal(g.cpu().view(torch.int32), r.cpu().view(torch.int32))


def _check_against_plain(handle, call) -> None:
    """One recorded call through the kernel and the plain version: the
    raster's channels bit for bit, the occlusion hit set exact, shade
    within 1e-5 on all but 0.05% of the pixels, tap and fetch 1e-6."""
    got, ref = handle.replay(call, True), handle.replay(call, False)
    if isinstance(ref, dict):  # the raster: every channel bit for bit
        for key, r in ref.items():
            assert torch.equal(got[key].cpu(), r.cpu()), key
        return
    if handle.name == "bvh_occlusion":
        assert torch.equal(got, ref)
        return
    g = torch.stack(list(got)).cpu().numpy()
    r = torch.stack(list(ref)).cpu().numpy()
    if handle.name == "shade":
        bad = ~np.isclose(g, r, atol=1e-5, rtol=0, equal_nan=True)
        assert bad.any(axis=0).sum() <= 5e-4 * g.shape[1]
    else:
        np.testing.assert_allclose(g, r, atol=1e-6, rtol=0)


def _occlusion_small_mesh(dead_every):
    """Kernel 5 and the plain walk over the packet table on a sphere over a
    plane (a ragged last leaf), 5000 numpy-seeded rays, every
    ``dead_every``-th one dead -> (kernel hits, plain hits)."""
    from transmission_renderer_tpu_torch.models.procedural import make_plane_mesh, make_sphere_mesh
    from transmission_renderer_tpu_torch.ops import bvh, bvh_packet

    p1, _, _, i1 = make_sphere_mesh(20, 41)
    p2, _, _, i2 = make_plane_mesh(4.0, y=-1.2)
    pos = np.concatenate([p1, p2]).astype(np.float32)
    idx = np.concatenate([i1.reshape(-1, 3), i2.reshape(-1, 3) + len(p1)]).astype(np.int32)
    assert len(idx) % bvh.LEAF_TRIS
    rng = np.random.default_rng(11)
    o = rng.uniform(-2, 2, (5000, 3)).astype(np.float32)
    d = rng.normal(size=(5000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = rng.uniform(0.5, 20.0, 5000).astype(np.float32)
    tm[::dead_every] = 0.0
    dev = torch.device("cuda")
    tree = bvh.build_bvh(idx, pos, device=dev)
    t_idx, t_pos = torch.from_numpy(idx).to(dev), torch.from_numpy(pos).to(dev)
    table = bvh_packet.kernel_walk_table(tree, t_idx, t_pos)
    rays = bvh_packet.ray_planes(torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
                                 torch.from_numpy(tm).to(dev))
    before = bvh_packet.KERNEL.launches
    got = bvh_packet.KERNEL(True, tree, table, rays, 0.001)
    torch.cuda.synchronize()
    assert bvh_packet.KERNEL.launches == before + 1
    packet = bvh_packet.packet_walk_table(tree, t_idx, t_pos)
    ref = bvh.trace_occlusion_plain(tree, packet.cpu(), rays.cpu())
    assert bool(ref.any()) and not bool(ref.all())
    return got.cpu(), ref


@pytest.mark.parametrize("h,w", [(72, 128), (37, 91), (900, 1600)])
def test_transmission_fetch_full_form_matches_plain(h, w):
    """Kernel 4's full-pyramid form (no level set: per-pixel roughness,
    the kernel over every level) against its plain version
    (mipchain.sample_pyramid_lod(level_set=None) and the LUT tap) at 1e-6, over odd level sizes, lods below 0 and past
    the top and uvs outside [0, 1]; its launch is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels build with nvcc for sm_90a)")
    from transmission_renderer_tpu_torch.ops import mipchain, tap_finish
    from transmission_renderer_tpu_torch.utils.ggx_lut import default_ggx_lut

    dev = torch.device("cuda")
    rng = np.random.default_rng(h + w)
    img = torch.from_numpy(rng.uniform(0, 4, (3, h, w)).astype(np.float32)).to(dev)
    pyr = mipchain.build_pyramid(tuple(img), level_set=None)
    m = 8192
    top = pyr.num_levels - 1

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    uv = rng.uniform(-0.2, 1.2, (m, 2))
    lod = rng.uniform(-2.0, top + 3.0, m)
    lod[: top + 1] = np.arange(top + 1)
    args = (pyr, None, t(uv[:, 0]), t(uv[:, 1]), t(lod), t(rng.uniform(-0.1, 1.1, m)),
            t(rng.uniform(0.0, 1.0, m)), t(default_ggx_lut(32)))
    before = tap_finish.FETCH_KERNEL.launches
    got = tap_finish.transmission_fetch_planes(*args)
    assert tap_finish.FETCH_KERNEL.launches == before + 1
    ref = tap_finish.transmission_fetch_planes_plain(*args)
    for g, r in zip(got, ref):
        assert float((g - r).abs().max()) <= 1e-6


def test_bvh_occlusion_small_mesh():
    """Kernel 5 alone: every 9th ray dead; the hit set equals the plain
    walk's over the packet table."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels build with nvcc for sm_90a)")
    got, ref = _occlusion_small_mesh(9)
    assert torch.equal(got, ref)


def test_bvh_occlusion_half_the_lanes_dead():
    """Every other ray dead, so half of each fetch is dropped and the warps
    refill: the hit set still equals the plain walk's, dead rays miss."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels build with nvcc for sm_90a)")
    got, ref = _occlusion_small_mesh(2)
    assert torch.equal(got, ref)
    assert not bool(got[::2].any())


# ---------------------------------------------------------------------------
# kernel 1: runs longer than a segment, ties across segments, seeds
# ---------------------------------------------------------------------------

def _gbuf_scene(dev, seed=3, n_tris=700, w=256, h=64):
    """Random triangles in front of the camera, every one twice (coplanar
    copies with other materials: exact depth ties), binned into 8x128
    tiles -> (payload, tile_start)."""
    from transmission_renderer_tpu_torch.ops import raster, raster_gbuf
    from transmission_renderer_tpu_torch.scene.camera import (
        look_at_rh, perspective_matrix_reversed)

    rng = np.random.default_rng(seed)
    pv = perspective_matrix_reversed(w, h) @ look_at_rh(
        (0.0, 1.0, 5.0), (0.0, 1.0, 0.0), (0, 1, 0))
    pos = rng.uniform(-2, 2, (3 * n_tris, 3)).astype(np.float32)
    tris = np.arange(3 * n_tris, dtype=np.int32).reshape(n_tris, 3)
    tris = np.concatenate([tris, tris])
    ph = np.concatenate([pos, np.ones((len(pos), 1), np.float32)], -1)
    clip = torch.from_numpy((ph @ pv.T).astype(np.float32)).to(dev)
    t = len(tris)
    tris_t = torch.from_numpy(tris).to(dev)
    setup = raster.setup_triangles(clip, tris_t, torch.ones(t, dtype=torch.bool, device=dev),
                                   w, h, 128, 8)
    cls = torch.from_numpy(np.tile(rng.integers(0, 2, t // 2), 2).astype(np.int32)).to(dev)
    bins = raster.bin_triangles(setup, w // 128, h // 8, 2, cls, 2,
                                ((8, 4096), (128, 2048), (2048, 64), (0, 16)))
    nrm = rng.normal(size=(len(pos), 3)).astype(np.float32)
    uv = rng.uniform(0, 1, (len(pos), 2)).astype(np.float32)
    mat = torch.from_numpy(np.arange(t, dtype=np.int32) % 7).to(dev)
    scale = torch.from_numpy(rng.uniform(0.5, 2.0, t).astype(np.float32)).to(dev)
    rec = raster_gbuf.pack_gbuf_payload(
        setup, tris_t, mat, scale, torch.from_numpy(pos).to(dev),
        torch.from_numpy(nrm).to(dev), torch.from_numpy(uv).to(dev), cls)
    return raster_gbuf.gather_gbuf_payload(rec, bins), bins.tile_start


@pytest.mark.parametrize("case", ["long-runs", "seeded", "peel"])
def test_raster_gbuf_segments_match_plain(case):
    """Kernel 1 on runs of several hundred records (more than one SEG
    segment, with coplanar twins tying across segments), a seeded pass
    over a repeated tile list and a depth-peel bound at exactly the front
    depths on half the pixels: every channel equals the plain version's
    on the same tensors on the CPU, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels build with nvcc for sm_90a)")
    from transmission_renderer_tpu_torch.ops import raster_gbuf

    w, h = 256, 64
    dev = torch.device("cuda")
    payload, ts = _gbuf_scene(dev)
    ids = torch.arange(16, dtype=torch.int32, device=dev)
    kw = {}
    if case != "long-runs":
        ids = torch.tensor([9, 11, 8, 9, 13, 14], dtype=torch.int32, device=dev)
        front = raster_gbuf.rasterize_gbuffer_tiles(payload, ids, ts, 0, w, h)["depth"]
        rng = np.random.default_rng(4)
        half = torch.from_numpy(rng.uniform(size=tuple(front.shape)) < 0.5).to(dev)
        scale = torch.from_numpy(rng.uniform(0.5, 1.5, tuple(front.shape))
                                 .astype(np.float32)).to(dev)
        bound = torch.where(half, front, front * scale).contiguous()
        kw = ({"init_depth_tiles": bound, "pass_class": 1} if case == "seeded"
              else {"max_depth_tiles": bound})
    before = raster_gbuf.KERNEL.launches
    got = raster_gbuf.rasterize_gbuffer_tiles(payload, ids, ts, 0, w, h, **kw)
    torch.cuda.synchronize()
    assert raster_gbuf.KERNEL.launches == before + 1
    cpu = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
    ref = raster_gbuf.rasterize_gbuffer_tiles(
        tuple(p.cpu() for p in payload), ids.cpu(), ts.cpu(), 0, w, h, **cpu)
    for key, r in ref.items():
        assert torch.equal(got[key].cpu(), r), key
    assert int((ref["tri"] >= 0).sum()) > (1000 if case == "long-runs" else 100)
    if case == "long-runs":
        nc = (ts.shape[0] - 1) // 16
        _, count = raster_gbuf._tile_runs(ts, ids, nc, None)
        assert int(count.max()) > raster_gbuf.SEG


@pytest.mark.parametrize("case", ["all", "class1-no-derivs", "1280-slots"])
def test_raster_gbuf_plan_matches_work_list(case):
    """The work list kernel 1's plan kernel leaves after a call (the words
    after the per-pixel keys: item counter, slot count, slot order,
    running segment count) against gbuf_work_list on the same runs: the
    same slots, the same segment-count buckets in order (slots of one
    bucket in any order), the running count of that order, and every item
    pulled. 1280 slots (a repeated tile list) take the plan's scan past
    one 1024-thread pass; the channels equal the 16-slot call's, repeated."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels build with nvcc for sm_90a)")
    from transmission_renderer_tpu_torch.ops import raster_gbuf

    w, h = 256, 64
    dev = torch.device("cuda")
    payload, ts = _gbuf_scene(dev)
    ids = torch.arange(16, dtype=torch.int32, device=dev)
    kw = {"pass_class": 1, "pos_derivs": False} if case == "class1-no-derivs" else {}
    if case == "1280-slots":
        ids = ids.repeat(80)
    out, keys = raster_gbuf._raster_launch(payload, ids, ts, 0, w, h, **kw)
    torch.cuda.synchronize()
    k = ids.numel()
    plan = keys[k * raster_gbuf.TILE_H * raster_gbuf.TILE_W:].cpu().view(torch.int32).long()
    _, count = raster_gbuf._tile_runs(ts.cpu(), ids.cpu(), (ts.shape[0] - 1) // 16,
                                      kw.get("pass_class"))
    order, seg_cum = raster_gbuf.gbuf_work_list(count)
    n_slots = int(plan[1])
    got_order, got_cum = plan[2 : 2 + n_slots], plan[2 + k : 2 + k + n_slots]
    assert n_slots == order.numel() > 0
    assert sorted(got_order.tolist()) == sorted(order.tolist())
    nseg = (count + raster_gbuf.SEG - 1) // raster_gbuf.SEG
    bucket = torch.clamp(nseg, max=raster_gbuf.PLAN_BUCKETS - 1)
    assert torch.equal(bucket[got_order], bucket[order])
    assert torch.equal(got_cum, torch.cumsum(nseg[got_order], 0))
    assert int(plan[0]) >= int(seg_cum[-1])  # every item pulled, then one miss a block
    if case == "1280-slots":
        small = raster_gbuf.rasterize_gbuffer_tiles(payload, ids[:16], ts, 0, w, h)
        for key, r in small.items():
            assert torch.equal(out[key], r.repeat(80, 1, 1)), key
    else:
        ref = raster_gbuf.rasterize_gbuffer_tiles(
            tuple(p.cpu() for p in payload), ids.cpu(), ts.cpu(), 0, w, h, **kw)
        for key, r in ref.items():
            assert torch.equal(out[key].cpu(), r), key


def _gbuf_big_list_case(dev, w=256, h=64):
    """Kernel 1's inputs over materialised bins (tile reach 2: every larger
    triangle is on the big list) of _vis_scene's triangles (two
    floor triangles and crowded small ones), the big list extended with
    copies of run records under other materials (exact ties between a
    big record and a run record) -> (payload, tile_start, big_count)."""
    from transmission_renderer_tpu_torch.ops import raster, raster_gbuf

    clip_np, tris_np = _vis_scene(5, n_tris=300)
    rng = np.random.default_rng(2)
    t = len(tris_np)
    clip = torch.from_numpy(clip_np).to(dev)
    tris = torch.from_numpy(tris_np).to(dev)
    setup = raster.setup_triangles(clip, tris, torch.ones(t, dtype=torch.bool, device=dev),
                                   w, h, 128, 8)
    bins = raster.bin_triangles_materialized(setup, w // 128, h // 8, 2, 512, 16)
    nv = clip_np.shape[0]
    pos = torch.from_numpy(rng.uniform(-2, 2, (nv, 3)).astype(np.float32)).to(dev)
    nrm = torch.from_numpy(rng.normal(size=(nv, 3)).astype(np.float32)).to(dev)
    uv = torch.from_numpy(rng.uniform(0, 1, (nv, 2)).astype(np.float32)).to(dev)
    cls = torch.from_numpy(rng.integers(0, 2, t).astype(np.int32)).to(dev)
    mat = torch.arange(t, dtype=torch.int32, device=dev) % 7
    scale = torch.from_numpy(rng.uniform(0.5, 2.0, t).astype(np.float32)).to(dev)
    rec = raster_gbuf.pack_gbuf_payload(setup, tris, mat, scale, pos, nrm, uv, cls)
    rows, big_rows = raster_gbuf.gather_gbuf_payload(rec, bins)
    nbig = int(bins.big_tri_count)
    runs = rows.reshape(-1, raster_gbuf.REC_F32)
    live = runs[runs[:, 15] >= 0]
    copies = live[torch.from_numpy(rng.permutation(live.shape[0])[:9]).to(dev)].clone()
    copies[:, 40] = 100.0 + torch.arange(copies.shape[0], dtype=torch.float32, device=dev)
    big = torch.cat([big_rows.reshape(-1, raster_gbuf.REC_F32)[:nbig], copies])
    big = torch.cat([big, big.new_zeros(big.shape[0] % 2, raster_gbuf.REC_F32)])
    count = torch.tensor([nbig + copies.shape[0]], dtype=torch.int32, device=dev)
    assert nbig >= 2
    return (rows, big.reshape(-1, 128).contiguous()), bins.tile_start, count


@pytest.mark.parametrize("case", ["all", "class1-seeded", "peel"])
def test_raster_gbuf_big_list_matches_plain(case):
    """Kernel 1 with a big list walked before every tile's run (the
    reference's big_body), ties between a big record and a run record
    included: every channel equals the plain version's bit for bit, on
    every tile, under a class filter with a seed, and under a peel bound
    at exactly the front depth on half the pixels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels build with nvcc for sm_90a)")
    from transmission_renderer_tpu_torch.ops import raster_gbuf

    w, h = 256, 64
    dev = torch.device("cuda")
    payload, ts, nbig = _gbuf_big_list_case(dev)
    ids = torch.arange(16, dtype=torch.int32, device=dev)
    kw = {}
    if case != "all":
        ids = torch.tensor([9, 11, 8, 9, 13, 14, 0], dtype=torch.int32, device=dev)
        front = raster_gbuf.rasterize_gbuffer_tiles(payload, ids, ts, nbig, w, h)["depth"]
        rng = np.random.default_rng(4)
        half = torch.from_numpy(rng.uniform(size=tuple(front.shape)) < 0.5).to(dev)
        bound = torch.where(half, front, front * 1.3).contiguous()
        kw = ({"init_depth_tiles": bound * 0.5, "pass_class": 1} if case == "class1-seeded"
              else {"max_depth_tiles": bound})
    got = raster_gbuf.rasterize_gbuffer_tiles(payload, ids, ts, nbig, w, h, **kw)
    cpu = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
    ref = raster_gbuf.rasterize_gbuffer_tiles(tuple(p.cpu() for p in payload), ids.cpu(),
                                              ts.cpu(), nbig.cpu(), w, h, **cpu)
    for key, r in ref.items():
        assert torch.equal(got[key].cpu(), r), key
    if case == "all":
        assert (ref["material"] >= 100).any()  # a big copy won its tie


def _random_gbuf_inputs(dev, seed=5, w=256, h=64, n_v=60, n_t=60):
    """tests/test_torch_raster_gbuf.py::_inputs (random triangles, some
    near or behind the camera, both windings, two classes) binned into
    materialised bins with a tile reach of 2 -> (records, bins)."""
    from transmission_renderer_tpu_torch.ops import raster, raster_gbuf
    from transmission_renderer_tpu_torch.scene.camera import (
        look_at_rh, perspective_matrix_reversed)

    rng = np.random.default_rng(seed)
    pv = perspective_matrix_reversed(w, h) @ look_at_rh(
        (0.0, 1.0, 5.0), (0.0, 1.0, 0.0), (0, 1, 0))
    pos = rng.uniform(-2, 2, (n_v, 3)).astype(np.float32)
    pos[:4, 2] = rng.uniform(4.0, 7.0, 4)
    nrm = rng.normal(size=(n_v, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    uv = rng.uniform(0, 1, (n_v, 2)).astype(np.float32)
    tris = rng.integers(0, n_v, (n_t, 3))
    tris = tris[(tris[:, 0] != tris[:, 1]) & (tris[:, 1] != tris[:, 2])
                & (tris[:, 0] != tris[:, 2])].astype(np.int32)
    mat = rng.integers(0, 5, len(tris)).astype(np.int32)
    scale = rng.uniform(0.5, 2.0, len(tris)).astype(np.float32)
    cls = rng.integers(0, 2, len(tris)).astype(np.int32)
    enabled = rng.uniform(size=len(tris)) < 0.9
    ph = np.concatenate([pos, np.ones((n_v, 1), np.float32)], -1)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    setup = raster.setup_triangles(t((ph @ pv.T).astype(np.float32)), t(tris), t(enabled),
                                   w, h, 128, 8)
    bins = raster.bin_triangles_materialized(setup, w // 128, h // 8, 2, 64, 16)
    rec = raster_gbuf.pack_gbuf_payload(setup, t(tris), t(mat), t(scale), t(pos), t(nrm),
                                        t(uv), t(cls))
    return rec, bins


@pytest.mark.parametrize("pass_class,pos_derivs,uv_channels", [
    (None, True, True), (1, False, True), (0, False, False)])
def test_raster_gbuf_pallas_big_list_matches_plain(pass_class, pos_derivs, uv_channels):
    """rasterize_gbuffer_pallas over materialised bins on the inputs of
    tests/test_torch_raster_gbuf.py::test_plain_raster_walks_the_big_list_as_the_reference
    (which holds the plain version to the reference's kernel): the CUDA
    kernel, reading the big list's count on the card, gives every G-buffer
    field bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels build with nvcc for sm_90a)")
    from transmission_renderer_tpu_torch.ops import raster_gbuf

    out = []
    for dev in (torch.device("cuda"), torch.device("cpu")):
        rec, bins = _random_gbuf_inputs(dev)
        assert int(bins.big_tri_count) > 0
        out.append(raster_gbuf.rasterize_gbuffer_pallas(
            rec, bins, 256, 64, pass_class=pass_class, pos_derivs=pos_derivs,
            uv_channels=uv_channels))
    for f, a, b in zip(out[1]._fields, out[0], out[1]):
        assert torch.equal(a.cpu(), b), f


def test_raster_gbuf_plan_matches_work_list_with_a_big_list():
    """The plan's words with a big list: every slot walks nbig + its run,
    so every slot is in the order, by the segment count of that list."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels build with nvcc for sm_90a)")
    from transmission_renderer_tpu_torch.ops import raster_gbuf

    w, h = 256, 64
    dev = torch.device("cuda")
    payload, ts, nbig = _gbuf_big_list_case(dev)
    ids = torch.arange(16, dtype=torch.int32, device=dev)
    out, keys = raster_gbuf._raster_launch(payload, ids, ts, nbig, w, h)
    torch.cuda.synchronize()
    k = ids.numel()
    plan = keys[k * raster_gbuf.TILE_H * raster_gbuf.TILE_W:].cpu().view(torch.int32).long()
    _, count = raster_gbuf._tile_runs(ts.cpu(), ids.cpu(), 1, None)
    lengths = int(nbig[0]) + count
    order, seg_cum = raster_gbuf.gbuf_work_list(lengths)
    n_slots = int(plan[1])
    got_order, got_cum = plan[2 : 2 + n_slots], plan[2 + k : 2 + k + n_slots]
    assert n_slots == order.numel() == k
    assert sorted(got_order.tolist()) == sorted(order.tolist())
    nseg = (lengths + raster_gbuf.SEG - 1) // raster_gbuf.SEG
    bucket = torch.clamp(nseg, max=raster_gbuf.PLAN_BUCKETS - 1)
    assert torch.equal(bucket[got_order], bucket[order])
    assert torch.equal(got_cum, torch.cumsum(nseg[got_order], 0))
    assert int(plan[0]) >= int(seg_cum[-1])


# ---------------------------------------------------------------------------
# kernel 6: the visibility raster
# ---------------------------------------------------------------------------

def _vis_scene(seed, n_tris=400, w=256, h=64):
    """Crowded small triangles and two floor triangles whose full-screen
    bboxes send them to the big list -> (clip [V, 4], tris [T, 3]) numpy."""
    from transmission_renderer_tpu_torch.scene.camera import (
        look_at_rh, perspective_matrix_reversed)

    rng = np.random.default_rng(seed)
    pv = perspective_matrix_reversed(w, h) @ look_at_rh(
        (0.0, 1.0, 0.0), (0.0, 0.5, -3.0), (0, 1, 0))
    s = 50.0
    plane = np.array([[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]], np.float32)
    centres = rng.uniform(-1.5, 1.5, (n_tris, 1, 3)) * [1.5, 0.4, 1.0] + [0.0, 0.9, -3.0]
    pts = (centres + rng.uniform(-0.3, 0.3, (n_tris, 3, 3))).reshape(-1, 3)
    pos = np.concatenate([plane, pts]).astype(np.float32)
    tris = np.concatenate([[[0, 2, 1], [0, 3, 2]],
                           np.arange(3 * n_tris).reshape(n_tris, 3) + 4]).astype(np.int32)
    ph = np.concatenate([pos, np.ones((len(pos), 1), np.float32)], -1)
    return (ph @ pv.T).astype(np.float32), tris


def _vis_compare(got, ref, min_covered=1000):
    """Triangle ids, depth and barycentrics equal bit for bit."""
    for name, g, r in zip(("tri", "depth", "b1", "b2"), got, ref):
        g, r = g.cpu(), r.cpu()
        if r.is_floating_point():
            g, r = g.view(torch.int32), r.view(torch.int32)
        assert torch.equal(g, r), name
    assert int((ref[0] >= 0).sum()) > min_covered


@pytest.mark.parametrize("case", ["kernel6", "kernel6-class0", "kernel6-class1",
                                  "xla-128x8", "xla-32x8", "xla-cut", "xla-seeded"])
def test_raster_vis_matches_plain(case):
    """Kernel 6 launched through rasterize_pallas (kernel-6 order) and
    rasterize (XLA-raster order) on CUDA tensors vs the plain version on
    the same tensors on the CPU, bit for bit: class-filtered passes, 32x8
    tiles, bins cut below the busiest tiles' counts, and a seeded depth
    race."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels build with nvcc for sm_90a)")
    from transmission_renderer_tpu_torch.ops import raster, raster_vis

    w, h = 256, 64
    clip, tris = _vis_scene(7)
    tw, th = (32, 8) if case == "xla-32x8" else (128, 8)
    cap = 12 if case == "xla-cut" else 1024
    rng = np.random.default_rng(5)
    cls = torch.from_numpy(rng.integers(0, 2, len(tris)).astype(np.int32))
    init = np.zeros((h, w), np.float32)
    init[:, : w // 4] = 0.9
    init[:, w // 4:] = np.linspace(0.0, 4e-3, w - w // 4, dtype=np.float32)

    def run(dev):
        setup = raster.setup_triangles(torch.from_numpy(clip).to(dev),
                                       torch.from_numpy(tris).to(dev),
                                       torch.ones(len(tris), dtype=torch.bool, device=dev),
                                       w, h, tw, th)
        bins = raster.bin_triangles_materialized(setup, -(-w // tw), -(-h // th), 8, cap, 16)
        assert int(bins.big_tri_count) == 2
        seed = torch.from_numpy(init).to(dev) if case == "xla-seeded" else None
        if case.startswith("kernel6"):
            pc = int(case[-1]) if "class" in case else None
            payload = (raster_vis.gather_bin_payload(setup, bins, cls.to(dev))
                       if pc is not None else None)
            vis = raster_vis.rasterize_pallas(setup, bins, w, h, pass_class=pc,
                                              payload=payload)
        else:
            vis = raster_vis.rasterize(setup, bins, w, h, tw, th, init_depth=seed)
        if case == "xla-cut":
            assert int(bins.max_bin_count) > cap
        return vis

    before = raster_vis.KERNEL.launches
    got = run(torch.device("cuda"))
    torch.cuda.synchronize()
    assert raster_vis.KERNEL.launches == before + 1
    ref = run(torch.device("cpu"))
    assert raster_vis.KERNEL.launches == before + 1  # the CPU run launched nothing
    _vis_compare((got.tri_id, got.depth, got.bary[..., 0], got.bary[..., 1]),
                 (ref.tri_id, ref.depth, ref.bary[..., 0], ref.bary[..., 1]))


@pytest.fixture(scope="module", params=sorted(SCENES))
def vis_captured(request):
    """One small visibility-buffer frame (use_pallas_raster=False) of a
    scene on the card, every kernel call recorded."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels build with nvcc for sm_90a)")
    from transmission_renderer_tpu_torch.ops import raster_vis
    from transmission_renderer_tpu_torch.pbr.lights import pack_lights, point_light
    from transmission_renderer_tpu_torch.render.frame import make_frame_params, render_frame
    from transmission_renderer_tpu_torch.scene.camera import CameraRig

    dev = torch.device("cuda")
    scene, dl, flags = SCENES[request.param]().finish_bundle(device=dev)
    cfg = RenderConfig(width=200, height=120, tile_w=32, tile_h=8, use_pallas_raster=False)
    rig = CameraRig()
    rig.camera.position = np.array([0.0, 2.2, 1.5], np.float32)
    rig.camera.pitch = -0.25
    params = make_frame_params(cfg, rig.camera.view_matrix(), rig.camera.position,
                               rig.sun_dir(), device=dev)
    lights = pack_lights([
        point_light([0.0, 0.8, 0.0], [1, 0, 0], 5.0),
        spot_light([-1.0, 2.5, -3.0], [0.3, 0.4, 1.0], 14.0, [0.3, -1.0, -0.2], 0.3, 0.7),
    ], device=dev)
    handles = _handles() + (raster_vis.KERNEL,)
    for h in handles:
        h.recorder = []
        h.launches = 0
    img = render_frame(scene, dl, params, lights, cfg, flags=flags)
    torch.cuda.synchronize()
    out = {h.name: (h.recorder, h.launches) for h in handles}
    for h in handles:
        h.recorder = None
    return request.param, img, out


def test_vis_frame_launches_only_raster_vis(vis_captured):
    name, img, out = vis_captured
    glass = name == "dragon"
    assert {n: launches for n, (_, launches) in out.items()} == {
        "raster_gbuf": 0, "tap_finish": 0, "shade": 0, "transmission_fetch": 0,
        "bvh_occlusion": 0, "raster_vis": 1 + glass}
    assert bool(torch.isfinite(img).all())


def test_vis_frame_raster_matches_plain(vis_captured):
    """The frame's own kernel-6 calls (XLA-raster order, the transmissive
    one seeded with the opaque depth) through the kernel and the plain
    version, and again in kernel-6 order."""
    from transmission_renderer_tpu_torch.ops import raster_vis

    _, _, out = vis_captured
    calls, _ = out["raster_vis"]
    for args, kwargs in calls:
        for order in (True, False):
            call = (args, dict(kwargs, xla_order=order))
            _vis_compare(raster_vis.KERNEL.replay(call, True),
                         raster_vis.KERNEL.replay(call, False))


def _vis_call(dev, case, n_tris=400):
    """raster_vis arguments and keywords of a crafted case on ``dev``, over
    every 8x128 tile of a 256x64 frame of _vis_scene (the floor in the big
    list): "twins" (every triangle twice, coplanar: depth ties inside a
    run and across segments), "big-vs-run" (the floor's copies, larger
    ids, as the big list and the floor itself inside every run: the two
    orders keep different triangles on the ties), "seeded" (a seed at
    exactly the front depths on half the pixels), "neg-zero" (40 twin
    pairs at depth -0 and +0 on the same pixels, raced from a seed of -1),
    "class1" (class-flagged records, one pass), "long" (runs of several
    hundred records, more than one segment)."""
    from transmission_renderer_tpu_torch.ops import raster, raster_vis

    w, h = 256, 64
    clip, tris = _vis_scene(7, 1200 if case == "long" else n_tris)
    if case in ("twins", "neg-zero"):
        tris = np.concatenate([tris, tris])
    if case == "big-vs-run":
        tris = np.concatenate([tris, tris[:2]])
    cls = None
    if case == "class1":
        cls = torch.from_numpy(np.random.default_rng(5).integers(0, 2, len(tris))
                               .astype(np.int32)).to(dev)
    setup = raster.setup_triangles(torch.from_numpy(clip).to(dev), torch.from_numpy(tris).to(dev),
                                   torch.ones(len(tris), dtype=torch.bool, device=dev),
                                   w, h, 128, 8)
    bins = raster.bin_triangles_materialized(setup, 2, 8, 8, 4096, 16)
    payload = raster_vis.gather_bin_payload(setup, bins, cls)
    ids = torch.arange(16, dtype=torch.int32, device=dev)
    start = bins.tile_start[:16].contiguous()
    count = bins.tile_tri_count.to(torch.int32).contiguous()
    big_count = bins.big_tri_count.to(torch.int32).reshape(1)
    kw = {"pass_class": 1} if case == "class1" else {}
    if case == "big-vs-run":
        t = len(tris) - 2
        lists = [torch.cat([payload[0][s : s + c // 2], payload[2][:2],
                            payload[0][s + c // 2 : s + c]])
                 for s, c in zip(start.tolist(), count.tolist())]
        count = torch.tensor([len(r) for r in lists], dtype=torch.int32, device=dev)
        start = (torch.cumsum(count, 0) - count).to(torch.int32)
        payload = (torch.cat(lists), payload[2][[t, t + 1]].contiguous(), payload[2])
        big_count = torch.tensor([2], dtype=torch.int32, device=dev)
    if case == "neg-zero":
        ext = payload[2].clone()
        n = len(tris) // 2
        ext[:40, 9:12] = -0.0
        ext[n : n + 40, 9:12] = 0.0
        rid = lambda r: torch.where(r[:, 15] < 0, ext.shape[0] - 1,  # noqa: E731
                                    r[:, 15].long() & (raster_vis.CLASS_BIT - 1))
        payload = (ext[rid(payload[0])].contiguous(), ext[rid(payload[1])].contiguous(), ext)
        kw = {"init_depth_tiles": torch.full((16, 8, 128), -1.0, device=dev)}
    args = (payload, ids, start, count, big_count, w, h, 128, 8)
    if case == "seeded":
        front = raster_vis.raster_vis_plain(*_to_cpu(args, {})[0])[1]
        rng = np.random.default_rng(4)
        half = torch.from_numpy(rng.uniform(size=tuple(front.shape)) < 0.5)
        scale = torch.from_numpy(rng.uniform(0.5, 1.5, tuple(front.shape)).astype(np.float32))
        kw = {"init_depth_tiles": torch.where(half, front, front * scale).contiguous().to(dev)}
    return args, kw


def _to_cpu(args, kw):
    cpu = lambda a: (tuple(p.cpu() for p in a) if isinstance(a, tuple)  # noqa: E731
                     else a.cpu() if isinstance(a, torch.Tensor) else a)
    return tuple(cpu(a) for a in args), {k: cpu(v) for k, v in kw.items()}


@pytest.mark.parametrize("xla_order", [True, False])
@pytest.mark.parametrize("case", ["twins", "big-vs-run", "seeded", "neg-zero", "class1",
                                  "long"])
def test_raster_vis_race_resolve_ties_match_plain(case, xla_order):
    """Kernel 6's race and resolve on crafted ties, in both walk orders,
    against the plain sequential walk on the same tensors on the CPU: tri,
    depth (its sign bit too), b1 and b2 equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels build with nvcc for sm_90a)")
    from transmission_renderer_tpu_torch.ops import raster_vis

    args, kw = _vis_call(torch.device("cuda"), case)
    before = raster_vis.KERNEL.launches
    got = raster_vis.KERNEL(True, *args, xla_order=xla_order, **kw)
    torch.cuda.synchronize()
    assert raster_vis.KERNEL.launches == before + 1
    cargs, ckw = _to_cpu(args, kw)
    ref = raster_vis.raster_vis_plain(*cargs, xla_order=xla_order, **ckw)
    _vis_compare(got, ref, min_covered=300)
    if case == "neg-zero":
        assert bool((ref[1].view(torch.int32) == -2**31).any())
    if case == "long":
        assert int(args[3].max()) > raster_vis.SEG


@pytest.mark.parametrize("case", ["twins", "class1", "1280-slots"])
def test_raster_vis_plan_matches_work_list(case):
    """The work list kernel 6's plan kernel leaves after a call (the words
    after the per-pixel keys) against gbuf_work_list over list_lengths
    (each tile's big list and run): the same slots, the same segment-count
    buckets in order, the running count of that order, every item pulled;
    1280 slots take the plan's scan past one 1024-thread pass, and their
    outputs equal the 16-slot call's, repeated."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels build with nvcc for sm_90a)")
    from transmission_renderer_tpu_torch.ops import raster_gbuf, raster_vis

    dev = torch.device("cuda")
    args, kw = _vis_call(dev, "class1" if case == "class1" else "twins")
    if case == "1280-slots":
        args = (args[0], args[1].repeat(80), args[2].repeat(80), args[3].repeat(80)) + args[4:]
    out, keys = raster_vis._raster_vis_launch(*args, **kw)
    torch.cuda.synchronize()
    k = args[1].numel()
    plan = keys[k * 1024:].cpu().view(torch.int32).long()
    lengths = raster_vis.list_lengths(args[3].cpu(), args[4].cpu())
    order, seg_cum = raster_gbuf.gbuf_work_list(lengths, raster_vis.SEG)
    n_slots = int(plan[1])
    got_order, got_cum = plan[2 : 2 + n_slots], plan[2 + k : 2 + k + n_slots]
    assert n_slots == order.numel() > 0
    assert sorted(got_order.tolist()) == sorted(order.tolist())
    nseg = (lengths + raster_vis.SEG - 1) // raster_vis.SEG
    bucket = torch.clamp(nseg, max=raster_gbuf.PLAN_BUCKETS - 1)
    assert torch.equal(bucket[got_order], bucket[order])
    assert torch.equal(got_cum, torch.cumsum(nseg[got_order], 0))
    assert int(plan[0]) >= int(seg_cum[-1])  # every item pulled, then one miss a block
    if case == "1280-slots":
        small = raster_vis.KERNEL(True, *_vis_call(dev, "twins")[0])
        for g, r in zip(out, small):
            assert torch.equal(g, r.repeat(80, 1, 1))
    else:
        cargs, ckw = _to_cpu(args, kw)
        _vis_compare(out, raster_vis.raster_vis_plain(*cargs, **ckw), min_covered=300)


def test_shade_sky_spot_and_mixed_clusters_match_plain(captured):
    """Kernel 3 on a frame's opaque call with sky pixels (which only write
    zeros), a spot light that valid pixels evaluate, and warps whose valid
    pixels span several clusters beside warps on one cluster: within the
    shade tolerance of chip_smoke.py (1e-5 on all but 0.05% of the
    pixels), and exactly 0 on the sky."""
    from transmission_renderer_tpu_torch.render import shade_kernel

    _, _, out = captured
    (inp, spec), kw = out["shade"][0][0]
    w = shade_kernel.shade_work(inp, spec)
    assert 0 < w.valid < inp.mid.numel()
    assert 0 < w.uniform_warps < w.warps
    m = inp.mid.numel()
    blk = torch.arange(m, device=inp.mid.device) // 128
    lane = (torch.arange(m, device=inp.mid.device) % 128).to(torch.float32)
    cl = shade_kernel.pixel_clusters(spec, inp.pix[6], inp.block_px0[blk].float() + lane,
                                     inp.block_py[blk].float()).long()
    slot = torch.arange(inp.indices.shape[1], device=cl.device)
    listed = (slot[None] < inp.counts[cl][:, None]) & (inp.indices[cl] == 2)
    assert bool((listed.any(dim=1) & (inp.pix[7] > 0.5)).any())  # the spot (light 2)
    got = torch.stack(shade_kernel.KERNEL.replay(((inp, spec), kw), True)).cpu().numpy()
    ref = torch.stack(shade_kernel.KERNEL.replay(((inp, spec), kw), False)).cpu().numpy()
    bad = ~np.isclose(got, ref, atol=1e-5, rtol=0, equal_nan=True)
    assert bad.any(axis=0).sum() <= 5e-4 * got.shape[1]
    sky = (inp.pix[7] <= 0.5).cpu().numpy()
    assert (got[:, sky] == 0).all()


# ---------------------------------------------------------------------------
# the bench's other scenes (chip_smoke.py phase 10 at full size)
# ---------------------------------------------------------------------------

def _smoke():
    """The repo's chip_smoke.py, which defines the bench scenes, loaded as
    a module."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.fixture(scope="module", params=["helmet", "smooth", "attenuation", "bindless"])
def bench_captured(request):
    """One 256x144 kernel-branch frame of a bench scene on the card, at the
    bench's size, block caps, camera and lights (chip_smoke.py::bench_scene;
    a cap may overflow at this size, which drops blocks but no kernel
    call), every kernel call recorded -> (name, image, {kernel: (calls,
    launches)}, the launches the frame must make)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels build with nvcc for sm_90a)")
    import dataclasses

    from transmission_renderer_tpu_torch.render.frame import render_frame

    smoke = _smoke()
    dev = torch.device("cuda")
    name = request.param
    scene, dl, flags, cfg, _, lights = smoke.bench_scene(name, dev)
    cfg = dataclasses.replace(cfg, width=256, height=144, sparse_raster_tile_floor=1)
    params = smoke.make_params(cfg, smoke.bench_rig(0), dev)
    expect = dict(smoke.expected_launches(scene, flags), bvh_occlusion=0)
    handles = _handles()
    for h in handles:
        h.recorder = []
        h.launches = 0
    img = render_frame(scene, dl, params, lights, cfg, flags=flags)
    torch.cuda.synchronize()
    out = {h.name: (h.recorder, h.launches) for h in handles}
    for h in handles:
        h.recorder = None
    return name, img, out, expect


def test_bench_frame_builds_and_renders(bench_captured):
    """Each bench scene's frame renders on the card: finite, in [0, 1],
    with the launches its passes and meta blocks call for."""
    name, img, out, expect = bench_captured
    assert {n: launches for n, (_, launches) in out.items()} == expect
    assert tuple(img.shape) == (144, 256, 3) and bool(torch.isfinite(img).all())
    assert 0.0 <= float(img.min()) and float(img.max()) <= 1.0


@pytest.mark.parametrize("name", ["raster_gbuf", "tap_finish", "shade", "transmission_fetch"])
def test_bench_kernel_matches_plain(bench_captured, name):
    """Each of the frame's calls through the kernel and the plain version,
    at test_kernel_matches_plain's tolerances, on what only these scenes
    send: kernel 2 on a 4-layer bundle beside 1-layer images (helmet) and
    once per meta block over 72 mixed-size images (bindless); kernel 3 on
    82 materials and 48 lights, 4 of them spots (bindless) and on the
    normal-map and emissive slots (helmet); kernel 4 on level set (0,)
    (smooth, attenuation)."""
    handle = {h.name: h for h in _handles()}[name]
    scene, _, out, expect = bench_captured
    calls, _ = out[name]
    assert len(calls) == expect[name]
    if scene == "bindless" and name == "tap_finish":
        sizes = set(torch.cat([c[0][1][:, 2] for c in calls]).tolist())
        assert len(calls) == 3 and {48, 96, 192} & sizes
    if scene == "helmet" and name == "tap_finish":
        assert calls[0][0][5] == (1, 4)
    if scene == "bindless" and name == "shade":
        inp = calls[0][0][0]
        assert inp.mat.shape[0] == 82 and inp.lmat.shape[0] == 48
        assert int((inp.lmat[:, 11] > 0.5).sum()) == 4 and int(inp.counts.max()) > 16
    if name == "transmission_fetch":
        assert all(tuple(c[0][1]) == (0,) for c in calls)
    for call in calls:
        _check_against_plain(handle, call)


# ---------------------------------------------------------------------------
# the closest-hit, alpha-tested walk (the AS-debug caster) and the CLI
# ---------------------------------------------------------------------------

def _clip_textured():
    """The textured scene with its 4-layer bundle's diffuse layer
    alpha-tested (a two-class atlas: the caster's tap selects a layer)."""
    from transmission_renderer_tpu_torch.config import BUCKET_ALPHA_CLIP
    from transmission_renderer_tpu_torch.models.procedural import make_plane_mesh

    b = _textured()
    rng = np.random.default_rng(5)
    layers = [rng.integers(0, 256, (32, 32, 4)).astype(np.uint8) for _ in range(2)]
    refs = b.add_texture_bundle([(layers[0], True), (layers[1], False)])
    card = b.add_material(tex_diffuse=refs[1], alpha_clipping_cutoff=0.5)
    b.add_instance(b.add_primitive(*make_plane_mesh(2.0), bucket=BUCKET_ALPHA_CLIP), card,
                   translation=(0.0, 1.0, -2.0),
                   rotation=np.array([np.sin(np.pi / 4), 0, 0, np.cos(np.pi / 4)], np.float32))
    return b


@pytest.mark.parametrize("scene", ["stress", "clip-textured"])
def test_bvh_closest_matches_plain(scene):
    """The AS-debug frame's closest-hit call at 256x144 (every 7th ray
    dead): hit, tri id, t, u and v equal to the plain walk's; the alpha
    test rejects some candidate."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels build with nvcc for sm_90a)")
    from transmission_renderer_tpu_torch.models.procedural import build_stress_scene
    from transmission_renderer_tpu_torch.ops import bvh_closest
    from transmission_renderer_tpu_torch.render.frame import make_frame_params
    from transmission_renderer_tpu_torch.render.raytrace import render_as_debug_frame
    from transmission_renderer_tpu_torch.scene.camera import CameraRig

    dev = torch.device("cuda")
    builder = build_stress_scene(grid=2) if scene == "stress" else _clip_textured()
    s, dl, _ = builder.finish_bundle(device=dev)
    cfg = RenderConfig(width=256, height=144, ray_traced_shadows=True)
    rig = CameraRig()
    rig.camera.position = np.array([0.0, 3.0, 2.5], np.float32)
    rig.camera.pitch = -0.5
    params = make_frame_params(cfg, rig.camera.view_matrix(), rig.camera.position,
                               rig.sun_dir(), device=dev)
    h = bvh_closest.KERNEL
    h.recorder, before = [], h.launches
    img = render_as_debug_frame(s, dl, params, None, cfg, builder.build_rt_bvh(device=dev))
    torch.cuda.synchronize()
    (call,), h.recorder = h.recorder, None
    assert h.launches == before + 1 and bool(torch.isfinite(img).all())
    (tree, table, rays, t_min, alpha), kw = call
    rays = rays.clone()
    rays[9, ::7] = 0.0
    call = ((tree, table, rays, t_min, alpha), kw)
    got, ref = h.replay(call, True), h.replay(call, False)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert not bool(got[0][::7].any()) and bool(got[0].any())
    no_clip = alpha._replace(cutoff=torch.full_like(alpha.cutoff, -torch.inf))
    geo = h.replay(((tree, table, rays, t_min, no_clip), kw), True)
    assert bool((geo[0] & (geo[2] != got[2])).any())


def test_cli_on_the_card(tmp_path):
    """cli.main at 256x144 on the card: the kernel branch's frame, and
    the AS-debug view through the closest-hit kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels build with nvcc for sm_90a)")
    from transmission_renderer_tpu_torch import cli
    from transmission_renderer_tpu_torch.ops import bvh_closest, raster_gbuf

    small = ["--width", "256", "--height", "144", "--procedural", "dragon", "--detail", "0.2"]
    for extra, handle in (([], raster_gbuf.KERNEL), (["--as-debug"], bvh_closest.KERNEL)):
        frames, before = [], handle.launches
        assert cli.main(small + extra + ["-o", str(tmp_path / "f.png")],
                        frames_out=frames) == 0
        assert handle.launches > before
        assert np.isfinite(frames[0]).all() and frames[0].max() > 0.0


# ---------------------------------------------------------------------------
# kernel 6's alpha form and checked form: the stress scene's vis frame
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def clip_captured():
    """The stress scene's visibility-buffer frame (alpha clip: kernel 6's
    alpha form in both passes) at 256x144 on the card, its kernel-6 calls
    recorded -> (scene, draw list, flags, params, lights, config, image,
    calls, launches)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels build with nvcc for sm_90a)")
    from transmission_renderer_tpu_torch.models.procedural import build_stress_scene
    from transmission_renderer_tpu_torch.ops import raster_vis
    from transmission_renderer_tpu_torch.pbr.lights import pack_lights, point_light
    from transmission_renderer_tpu_torch.render.frame import make_frame_params, render_frame
    from transmission_renderer_tpu_torch.scene.camera import CameraRig

    dev = torch.device("cuda")
    scene, dl, flags = build_stress_scene(grid=3).finish_bundle(device=dev)
    cfg = RenderConfig(width=256, height=144, use_pallas_raster=False)
    rig = CameraRig()
    rig.camera.position = np.array([0.0, 3.0, 2.5], np.float32)
    rig.camera.pitch = -0.5
    params = make_frame_params(cfg, rig.camera.view_matrix(), rig.camera.position,
                               rig.sun_dir(), device=dev)
    lights = pack_lights([point_light([0.0, 0.8, 0.0], [1, 0, 0], 5.0)], device=dev)
    handles = _handles() + (raster_vis.KERNEL,)
    for h in handles:
        h.recorder = []
        h.launches = 0
    img = render_frame(scene, dl, params, lights, cfg, flags=flags)
    torch.cuda.synchronize()
    launches = {h.name: h.launches for h in handles}
    calls = raster_vis.KERNEL.recorder
    for h in handles:
        h.recorder = None
    return scene, dl, flags, params, lights, cfg, img, calls, launches


def test_vis_clip_alpha_form_matches_plain(clip_captured):
    """Both passes through kernel 6's alpha form: tri, depth, b1, b2 bit
    for bit against the plain version, and the alpha test kills."""
    from transmission_renderer_tpu_torch.ops import raster_vis

    *_, img, calls, launches = clip_captured
    assert launches == {"raster_gbuf": 0, "tap_finish": 0, "shade": 0, "transmission_fetch": 0,
                        "bvh_occlusion": 0, "raster_vis": 2}
    assert bool(torch.isfinite(img).all())
    assert len(calls) == 2 and all("alpha" in kw for _, kw in calls)
    for call in calls:
        _vis_compare(raster_vis.KERNEL.replay(call, True), raster_vis.KERNEL.replay(call, False),
                     min_covered=100)
    args, kw = calls[0]
    no_alpha = {k: v for k, v in kw.items() if k != "alpha"}
    assert not torch.equal(raster_vis.KERNEL.replay((args, no_alpha), True)[0],
                           raster_vis.KERNEL.replay(calls[0], True)[0])


def test_vis_clip_checked_form(clip_captured):
    """The checked form: the checked frame prints nothing and equals the
    frame; a run start past the records and a diffuse texture past the
    atlas set their bits of the error word, and the context lives on."""
    import io

    from transmission_renderer_tpu_torch.ops import raster_vis
    from transmission_renderer_tpu_torch.render import checks
    from transmission_renderer_tpu_torch.render.checks import checked_frame_fn

    scene, dl, flags, params, lights, cfg, img, calls, _ = clip_captured
    log = io.StringIO()
    checked = checked_frame_fn(config=cfg, flags=flags, out=log)(scene, dl, params, lights)
    assert log.getvalue() == "" and torch.equal(checked, img)
    args, kw = calls[0]
    run_start = args[2].clone()
    run_start[int(torch.argmax(args[3]))] = args[0][0].shape[0] + 5
    alpha = kw["alpha"]
    n_images = alpha.atlas_meta.shape[0]
    bad_tex = alpha._replace(tex_diffuse=torch.where(
        alpha.tex_diffuse >= 0, torch.full_like(alpha.tex_diffuse, n_images),
        alpha.tex_diffuse))
    for bad_args, bad_kw, site in ((args[:2] + (run_start,) + args[3:], kw, 0),
                                   (args, dict(kw, alpha=bad_tex), 5)):
        with checks.collect() as found:
            raster_vis.KERNEL.replay((bad_args, bad_kw), True)
        torch.cuda.synchronize()
        assert (raster_vis.CHECK_SITES[site], None) in found, found
    with checks.collect() as found:
        got = raster_vis.KERNEL.replay(calls[0], True)
    assert found == []
    _vis_compare(got, raster_vis.KERNEL.replay(calls[0], False), min_covered=100)
