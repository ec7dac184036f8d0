"""The port's CUDA kernels vs their plain PyTorch versions, on the card,
at small shapes: one frame of each scene without ray-traced shadows,
with them, and with them traced at half resolution (kernel 5, and kernel
3 reading shadow factors, upsampled ones in the last), and kernel 5
alone on a small mesh; kernel 6 (the visibility raster) in both walk
orders on random scenes, and the visibility-buffer frame of each scene.
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


def _spot_light(position, colour, intensity, direction, inner, outer):
    """The reference's spot_light() dict (shared-structs/src/lib.rs:105-123)."""
    return dict(
        position=np.asarray(position, np.float32),
        colour_emission=np.asarray(colour, np.float32) * intensity,
        falloff_distance_sq=np.float32(intensity / 0.05),
        spot_epsilon=np.float32(np.cos(inner) - np.cos(outer)),
        spot_direction=np.asarray(direction, np.float32),
        spot_outer_angle=np.float32(outer),
    )


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
        _spot_light([-1.0, 2.5, -3.0], [0.3, 0.4, 1.0], 14.0, [0.3, -1.0, -0.2],
                    0.3, 0.7),
    ], device=dev)
    bvh = builder.build_rt_bvh(device=dev) if rt else None
    handles = _handles()
    for h in handles:
        h.recorder = []
        h.launches = 0
    img = render_frame(scene, dl, params, lights, cfg, flags, bvh=bvh)
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
    chip_smoke.py's tolerances: raster tri/material exact, depth 1e-7,
    attributes atol 1e-4 / rtol 1e-3; tap and fetch 1e-6; shade 1e-5 on
    all but 0.05% of the pixels (with the shadow factors in the -rt
    frames, upsampled in the -rt-half ones); the occlusion hit set exact."""
    from transmission_renderer_tpu_torch.ops import raster_gbuf

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
        got, ref = handle.replay(call, True), handle.replay(call, False)
        if isinstance(ref, dict):
            for key, r in ref.items():
                g, r = got[key].cpu().numpy(), r.cpu().numpy()
                if key in raster_gbuf.INT_CHANNELS:
                    np.testing.assert_array_equal(g, r, err_msg=key)
                elif key == "depth":
                    np.testing.assert_allclose(g, r, atol=1e-7, rtol=0)
                else:
                    np.testing.assert_allclose(g, r, atol=1e-4, rtol=1e-3, err_msg=key)
            continue
        if name == "bvh_occlusion":
            assert torch.equal(got, ref)
            continue
        g = torch.stack(list(got)).cpu().numpy()
        r = torch.stack(list(ref)).cpu().numpy()
        if name == "shade":
            bad = ~np.isclose(g, r, atol=1e-5, rtol=0, equal_nan=True)
            assert bad.any(axis=0).sum() <= 5e-4 * g.shape[1]
        else:
            np.testing.assert_allclose(g, r, atol=1e-6, rtol=0)


def test_bvh_occlusion_small_mesh():
    """Kernel 5 alone: a sphere over a plane, 5000 numpy-seeded rays with
    dead ones and a ragged last leaf; the hit set equals the plain walk's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels build with nvcc for sm_90a)")
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
    tm[::9] = 0.0
    dev = torch.device("cuda")
    tree = bvh.build_bvh(idx, pos, device=dev)
    t_idx, t_pos = torch.from_numpy(idx).to(dev), torch.from_numpy(pos).to(dev)
    table = bvh_packet.packet_walk_table(tree, t_idx, t_pos)
    rays = bvh_packet.ray_planes(torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
                                 torch.from_numpy(tm).to(dev))
    before = bvh_packet.KERNEL.launches
    got = bvh_packet.KERNEL(True, tree, table, rays, 0.001)
    torch.cuda.synchronize()
    assert bvh_packet.KERNEL.launches == before + 1
    ref = bvh.trace_occlusion_plain(tree, table.cpu(), rays.cpu())
    assert bool(ref.any()) and not bool(ref.all())
    assert torch.equal(got.cpu(), ref)


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


def _vis_compare(got, ref):
    """Triangle ids equal, depth within 1e-7, barycentrics within 1e-6."""
    g = [t.cpu().numpy() for t in got]
    r = [t.cpu().numpy() for t in ref]
    np.testing.assert_array_equal(g[0], r[0])
    np.testing.assert_allclose(g[1], r[1], atol=1e-7, rtol=0)
    for a, b in zip(g[2:], r[2:]):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    assert (r[0] >= 0).sum() > 1000


@pytest.mark.parametrize("case", ["kernel6", "kernel6-class0", "kernel6-class1",
                                  "xla-128x8", "xla-32x8", "xla-cut", "xla-seeded"])
def test_raster_vis_matches_plain(case):
    """Kernel 6 launched through rasterize_pallas (kernel-6 order) and
    rasterize (XLA-raster order) on CUDA tensors vs the plain version on
    the same tensors on the CPU: class-filtered passes, 32x8 tiles, bins
    cut below the busiest tiles' counts, and a seeded depth race."""
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
        _spot_light([-1.0, 2.5, -3.0], [0.3, 0.4, 1.0], 14.0, [0.3, -1.0, -0.2], 0.3, 0.7),
    ], device=dev)
    handles = _handles() + (raster_vis.KERNEL,)
    for h in handles:
        h.recorder = []
        h.launches = 0
    img = render_frame(scene, dl, params, lights, cfg, flags)
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
