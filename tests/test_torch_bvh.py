"""The port's BVH, occlusion walk, ray regrouping and cluster gate vs the
JAX package.

Geometry is tests/test_bvh_packet.py's (a displaced sphere over a plane,
2304 + 2 triangles); rays are numpy-seeded coherent bundles with every
7th ray dead (t_max = 0). The port's plain walk and its
trace_occlusion_packets (CPU tensors, so the same plain walk behind the
kernel's wrapper) must give exactly the reference's hit set, from both
its XLA bitstack walk (trace_rays(any_hit=True)) and its packet kernel in
interpret mode: the walks share every rounding step, and occlusion is an
existence predicate. The build and the refit must equal the reference's
arrays bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmission_renderer_tpu.models.procedural import _displaced_sphere, make_plane_mesh
from transmission_renderer_tpu.ops import bvh as jbvh
from transmission_renderer_tpu.ops import bvh_packet as jpacket
from transmission_renderer_tpu.render import raytrace as jraytrace
from transmission_renderer_tpu_torch.ops import bvh, bvh_packet
from transmission_renderer_tpu_torch.render import raytrace

# torch runs single-threaded here: the suite runs in several worker
# processes at once, and oversubscribed OpenMP threads stall each other
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def geo():
    p1, _, _, i1 = _displaced_sphere(24, 48)
    p2, _, _, i2 = make_plane_mesh(4.0, y=-1.2)
    pos = np.concatenate([p1, p2]).astype(np.float32)
    idx = np.concatenate([i1, i2 + len(p1)]).astype(np.int32)
    return idx, pos, jbvh.build_bvh(idx, pos), bvh.build_bvh(idx, pos, device="cpu")


def _rays(n, seed=3):
    rng = np.random.default_rng(seed)
    origins = np.repeat(rng.uniform(-2, 2, (n // 128, 3)), 128, axis=0)
    origins += rng.normal(0, 0.02, (n, 3))
    dirs = np.repeat(rng.normal(size=(n // 128, 3)), 128, axis=0)
    dirs += rng.normal(0, 0.05, (n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    t_max = rng.uniform(0.5, 50.0, n).astype(np.float32)
    t_max[::7] = 0.0
    return origins.astype(np.float32), dirs.astype(np.float32), t_max


def test_build_matches_reference(geo):
    _, _, ref, got = geo
    np.testing.assert_array_equal(got.node_boxes.numpy(), np.asarray(ref.node_boxes))
    np.testing.assert_array_equal(got.leaf_tri.numpy(), np.asarray(ref.leaf_tri))
    assert (got.level_offsets, got.level_counts, got.num_tris, got.num_leaves) == (
        ref.level_offsets, ref.level_counts, ref.num_tris, ref.num_leaves)
    assert bvh.wide_layout(got.num_tris) == jbvh.wide_layout(ref.num_tris)


def test_refit_matches_reference(geo):
    idx, pos, ref, got = geo
    moved = pos + np.random.default_rng(5).normal(0, 0.05, pos.shape).astype(np.float32)
    r = jbvh.refit_bvh(ref, jnp.asarray(idx), jnp.asarray(moved))
    g = bvh.refit_bvh(got, torch.from_numpy(idx), torch.from_numpy(moved))
    np.testing.assert_array_equal(g.node_boxes.numpy(), np.asarray(r.node_boxes))
    assert not np.array_equal(g.node_boxes.numpy(), got.node_boxes.numpy())


@pytest.fixture(scope="module")
def reference_hits(geo):
    idx, pos, ref, _ = geo
    o, d, tm = _rays(4096)
    xla, *_ = jbvh.trace_rays(ref, idx, pos, o, d, t_max=tm, any_hit=True)
    packets = jpacket.trace_occlusion_packets(ref, idx, pos, o, d, t_max=tm,
                                              interpret=True)
    xla, packets = np.asarray(xla), np.asarray(packets)
    assert xla.any() and not xla.all()
    np.testing.assert_array_equal(packets, xla)
    return (o, d, tm), xla


@pytest.mark.parametrize("walk", ["plain", "trace_occlusion_packets"])
def test_occlusion_matches_reference(geo, reference_hits, walk):
    """Exact: the hit set of 4096 rays, dead ones included, equals the
    reference's (its XLA walk and its packet kernel agree with each other
    in the fixture)."""
    idx, pos, _, got = geo
    (o, d, tm), ref = reference_hits
    t_idx, t_pos = torch.from_numpy(idx), torch.from_numpy(pos)
    if walk == "plain":
        table = bvh_packet.packet_walk_table(got, t_idx, t_pos)
        rays = bvh_packet.ray_planes(torch.from_numpy(o), torch.from_numpy(d),
                                     torch.from_numpy(tm))
        hit, inner, leaf, _ = bvh.occlusion_walk(got, table, rays)
        assert int(inner[tm == 0].sum()) == 0 and int(leaf.sum()) > 0
    else:
        hit = bvh_packet.trace_occlusion_packets(got, t_idx, t_pos, torch.from_numpy(o),
                                                 torch.from_numpy(d), t_max=torch.from_numpy(tm))
    assert hit.dtype == torch.bool and hit.shape == (4096,)
    np.testing.assert_array_equal(hit.numpy(), ref)


def test_occlusion_padding_and_scalar_tmax(geo, monkeypatch):
    """A ray count that fills no packet and is cut into uneven plain-walk
    chunks, with a scalar t_max."""
    idx, pos, ref, got = geo
    o, d, _ = _rays(4096)
    o, d = o[:1111], d[:1111]
    want, *_ = jbvh.trace_rays(ref, idx, pos, o, d, t_max=25.0, any_hit=True)
    monkeypatch.setattr(bvh, "RAY_CHUNK", 500)
    hit = bvh_packet.trace_occlusion_packets(got, torch.from_numpy(idx), torch.from_numpy(pos),
                                             torch.from_numpy(o), torch.from_numpy(d),
                                             t_max=25.0)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(want))
    assert np.asarray(want).any()


@pytest.mark.parametrize("mode,shape", [("2d", (16, 32, 3)), ("tiles", (2048, 2)),
                                        (None, (8, 16))])
def test_swizzle_matches_reference(mode, shape):
    a = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    swz, unswz = raytrace._packet_swizzle_fns(shape, mode)
    jswz, _ = jraytrace._packet_swizzle_fns(shape, mode)
    s = swz(torch.from_numpy(a))
    np.testing.assert_array_equal(s.numpy(), np.asarray(jswz(jnp.asarray(a))))
    np.testing.assert_array_equal(unswz(s).numpy(), a)


def test_cluster_light_mask_matches_reference():
    """The shadow-ray gate on a 256x64 grid of random depths under three
    lights; the reference's mask is taken under jit, as in its frame."""
    from transmission_renderer_tpu.config import RenderConfig
    from transmission_renderer_tpu.pbr.clustering import assign_lights_to_clusters
    from transmission_renderer_tpu.pbr.lights import pack_lights, point_light
    from transmission_renderer_tpu.render import frame as jframe
    from transmission_renderer_tpu.render import shading as jshading
    from transmission_renderer_tpu.scene.camera import CameraRig
    from transmission_renderer_tpu_torch.pbr.lights import pack_lights as ppack
    from transmission_renderer_tpu_torch.pbr.lights import point_light as ppoint
    from transmission_renderer_tpu_torch.render import shading

    cfg = RenderConfig(width=256, height=64)
    rig = CameraRig()
    rig.camera.position = np.array([0.0, 2.2, 1.5], np.float32)
    rig.camera.pitch = -0.25
    params = jframe.make_frame_params(cfg, rig.camera.view_matrix(), rig.camera.position,
                                      rig.sun_dir())
    def light_dicts(point_light):
        return [point_light([0.0, 0.8, 0.0], [1, 0, 0], 5.0),
                point_light([1.0, 0.5, -1.0], [0, 1, 0], 2.0),
                point_light([-2.0, 0.3, -3.0], [0, 0, 1], 1.0)]

    lights = pack_lights(light_dicts(point_light))
    coeffs, amin, amax = jframe._static_cluster_data(cfg)
    lp_h = jnp.concatenate([lights.position, jnp.ones_like(lights.position[:, :1])], -1)
    counts, indices = assign_lights_to_clusters(
        amin, amax, (lp_h @ params.view.T)[:, :3], lights.falloff_distance_sq,
        lights.is_a_spotlight(), lights.spot_direction @ params.view[:3, :3].T,
        lights.spot_outer_angle, cfg.max_lights_per_cluster)
    jctx = jshading.ShadeContext(
        view_position=params.view_position, proj_view=params.proj_view,
        sun_dir=params.sun_dir, sun_intensity=params.sun_intensity,
        framebuffer_size=(256, 64), cluster_size_in_pixels=cfg.cluster_size_in_pixels,
        num_clusters_xy=(cfg.num_clusters_x, cfg.num_clusters_y), cluster_coeffs=coeffs,
        cluster_light_counts=counts, cluster_light_indices=indices, lights=lights,
        ggx_lut=jnp.zeros((2, 2, 2)))
    pctx = shading.ShadeContext(
        view_position=None, proj_view=None, sun_dir=None, sun_intensity=None,
        framebuffer_size=(256, 64), cluster_size_in_pixels=cfg.cluster_size_in_pixels,
        num_clusters_xy=(cfg.num_clusters_x, cfg.num_clusters_y), cluster_coeffs=coeffs,
        cluster_light_counts=torch.from_numpy(np.asarray(counts).astype(np.int32)),
        cluster_light_indices=torch.from_numpy(np.asarray(indices).astype(np.int32)),
        lights=ppack(light_dicts(ppoint), device="cpu"), ggx_lut=None)
    # linear depths 0.05 .. 60 as reversed-Z depth values
    rng = np.random.default_rng(4)
    lin = np.exp(rng.uniform(np.log(0.05), np.log(60.0), (64, 256))).astype(np.float32)
    zn, zf = cfg.z_near, cfg.z_far
    depth = (1.0 - ((2 * zn * zf / lin - (zf + zn)) / -(zf - zn) + 1.0) / 2.0).astype(np.float32)
    px = np.broadcast_to(np.arange(256, dtype=np.int32)[None], (64, 256))
    py = np.broadcast_to(np.arange(64, dtype=np.int32)[:, None], (64, 256))
    ref = np.asarray(jax.jit(lambda d, x, y: jshading.cluster_light_mask(jctx, d, x, y))(
        depth, px, py))
    got = shading.cluster_light_mask(pctx, torch.from_numpy(depth), torch.from_numpy(px.copy()),
                                     torch.from_numpy(py.copy()))
    assert ref.any() and not ref.all()
    np.testing.assert_array_equal(got.numpy(), ref)


def test_shadow_factors_match_reference(geo):
    """shadow_factors over a 16x32 grid of surface points with the cluster
    gate, the N.L gate and the "2d" regrouping: factors equal."""
    from types import SimpleNamespace

    from transmission_renderer_tpu.pbr.lights import pack_lights, point_light
    from transmission_renderer_tpu_torch.pbr.lights import pack_lights as ppack
    from transmission_renderer_tpu_torch.pbr.lights import point_light as ppoint

    idx, pos, ref, got = geo
    rng = np.random.default_rng(9)
    tri = pos[idx[rng.integers(0, len(idx), 16 * 32)]]  # [512, 3, 3]
    w = rng.dirichlet(np.ones(3), 512).astype(np.float32)
    pts = np.einsum("nk,nkc->nc", w, tri).reshape(16, 32, 3).astype(np.float32)
    nrm = rng.normal(size=(16, 32, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    valid = rng.uniform(size=(16, 32)) < 0.9
    active = rng.uniform(size=(16, 32, 2)) < 0.7
    sun = np.array([0.3, 0.8, 0.2], np.float32)
    sun /= np.linalg.norm(sun)

    def lights(point_light):
        return [point_light([0.5, 2.0, 0.3], [1, 0, 0], 5.0),
                point_light([-1.5, 0.2, 1.0], [0, 1, 0], 3.0)]

    kw = dict(nol_gate=True, packet_swizzle="2d")
    r_sun, r_light = jraytrace.shadow_factors(
        ref, jnp.asarray(idx), jnp.asarray(pos),
        SimpleNamespace(position=jnp.asarray(pts), normal=jnp.asarray(nrm),
                        valid=jnp.asarray(valid)),
        jnp.asarray(sun), pack_lights(lights(point_light)),
        light_active=jnp.asarray(active), **kw)
    g_sun, g_light = raytrace.shadow_factors(
        got, torch.from_numpy(idx), torch.from_numpy(pos),
        SimpleNamespace(position=torch.from_numpy(pts), normal=torch.from_numpy(nrm),
                        valid=torch.from_numpy(valid)),
        torch.from_numpy(sun), ppack(lights(ppoint), device="cpu"),
        light_active=torch.from_numpy(active), **kw)
    assert g_light.shape == (16, 32, 2)
    np.testing.assert_array_equal(g_sun.numpy(), np.asarray(r_sun))
    np.testing.assert_array_equal(g_light.numpy(), np.asarray(r_light))
    assert (g_sun.numpy() == 0).any() and (g_light.numpy() == 0).any()


# ---------------------------------------------------------------------------
# the kernel's walk table (16-byte vectors: node planes, v0 / e1 / e2)
# ---------------------------------------------------------------------------

def test_kernel_walk_table_layout(geo):
    """Node rows are the boxes as 6 planes x 8 children; each leaf
    triangle is v0 and e1 = v1 - v0, e2 = v2 - v0 bit for bit (float32
    subtraction, as the walk does it), with a zero fourth lane."""
    idx, pos, _, got = geo
    table = bvh_packet.kernel_walk_table(got, torch.from_numpy(idx), torch.from_numpy(pos))
    boxes = got.node_boxes.numpy().reshape(-1, bvh.WIDE, 6)
    np.testing.assert_array_equal(table.nodes.numpy().reshape(-1, 6, bvh.WIDE),
                                  boxes.transpose(0, 2, 1))
    v = pos[idx[got.leaf_tri.numpy().reshape(-1)]]  # [L * 16, 3, 3]
    tris = table.tris.numpy().reshape(-1, 3, 4)
    assert tris.shape[0] == got.num_leaves * bvh.LEAF_TRIS
    np.testing.assert_array_equal(tris[:, 0, :3], v[:, 0])
    np.testing.assert_array_equal(tris[:, 1, :3], v[:, 1] - v[:, 0])
    np.testing.assert_array_equal(tris[:, 2, :3], v[:, 2] - v[:, 0])
    assert not tris[:, :, 3].any()
    assert table.nodes.is_contiguous() and table.tris.is_contiguous()


def test_kernel_table_walk_matches_packet_walk(geo, reference_hits):
    """The plain walk reading the kernel's table gives the packet table's
    hits and pops on every ray (dead ones included) and the reference's
    hit set."""
    idx, pos, _, got = geo
    (o, d, tm), ref = reference_hits
    t_idx, t_pos = torch.from_numpy(idx), torch.from_numpy(pos)
    rays = bvh_packet.ray_planes(torch.from_numpy(o), torch.from_numpy(d),
                                 torch.from_numpy(tm))
    packet = bvh.occlusion_walk(got, bvh_packet.packet_walk_table(got, t_idx, t_pos), rays)
    kernel = bvh.occlusion_walk(got, bvh_packet.kernel_walk_table(got, t_idx, t_pos), rays)
    for a, b in zip(kernel, packet):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(kernel[0].numpy(), ref)


def test_kernel_table_walk_ragged_leaf_half_dead():
    """A mesh whose last leaf is ragged, rays with every other one dead:
    the plain walk over either table gives the same hits and pops, and
    dead rays never pop."""
    from transmission_renderer_tpu.models.procedural import make_plane_mesh, make_sphere_mesh

    p1, _, _, i1 = make_sphere_mesh(20, 41)
    p2, _, _, i2 = make_plane_mesh(4.0, y=-1.2)
    pos = np.concatenate([p1, p2]).astype(np.float32)
    idx = np.concatenate([np.asarray(i1).reshape(-1, 3),
                          np.asarray(i2).reshape(-1, 3) + len(p1)]).astype(np.int32)
    tree = bvh.build_bvh(idx, pos, device="cpu")
    assert tree.num_tris % bvh.LEAF_TRIS
    rng = np.random.default_rng(11)
    o = rng.uniform(-2, 2, (3000, 3)).astype(np.float32)
    d = rng.normal(size=(3000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = rng.uniform(0.5, 20.0, 3000).astype(np.float32)
    tm[::2] = 0.0
    t_idx, t_pos = torch.from_numpy(idx), torch.from_numpy(pos)
    rays = bvh_packet.ray_planes(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tm))
    packet = bvh.occlusion_walk(tree, bvh_packet.packet_walk_table(tree, t_idx, t_pos), rays)
    kernel = bvh.occlusion_walk(tree, bvh_packet.kernel_walk_table(tree, t_idx, t_pos), rays)
    for a, b in zip(kernel, packet):
        assert torch.equal(a, b)
    hit, inner, leaf, tests = kernel
    assert bool(hit.any()) and not bool(hit[::2].any())
    assert int(inner[::2].sum()) == 0 and int(leaf[::2].sum()) == 0
    assert int(tests[::2].sum()) == 0


def _scalar_ray_tri(o, d, t_min, t_max, v0, e1, e2):
    """Kernel 5's triangle test as the kernel runs it, one float32 scalar
    at a time, leaving at the first failed test -> (hit, exit stage)."""
    f = np.float32
    pv = (d[1] * e2[2] - d[2] * e2[1], d[2] * e2[0] - d[0] * e2[2], d[0] * e2[1] - d[1] * e2[0])
    det = e1[0] * pv[0] + e1[1] * pv[1] + e1[2] * pv[2]
    if not abs(det) > f(1e-12):
        return False, 0
    inv = f(1.0) / det
    tv = (o[0] - v0[0], o[1] - v0[1], o[2] - v0[2])
    u = (tv[0] * pv[0] + tv[1] * pv[1] + tv[2] * pv[2]) * inv
    if not (u >= 0 and u <= 1):
        return False, 1
    qv = (tv[1] * e1[2] - tv[2] * e1[1], tv[2] * e1[0] - tv[0] * e1[2],
          tv[0] * e1[1] - tv[1] * e1[0])
    v = (d[0] * qv[0] + d[1] * qv[1] + d[2] * qv[2]) * inv
    if not (v >= 0 and u + v <= 1):
        return False, 2
    t = (e2[0] * qv[0] + e2[1] * qv[1] + e2[2] * qv[2]) * inv
    return bool(t > t_min and t < t_max), 3


def test_ray_tri_exit_stage_matches_the_early_leaving_test():
    """The plain test's hit and exit stage (what kernel 5's bound counts)
    equal a scalar float32 test that leaves at its first failure, on
    seeded rays aimed near seeded triangles: every stage occurs."""
    rng = np.random.default_rng(21)
    n = 600
    v = rng.uniform(-1, 1, (n, 3, 3)).astype(np.float32)
    v[::5, 2] = v[::5, 1]  # degenerate: the determinant fails
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    aim = v.mean(axis=1) + rng.normal(0, 0.6, (n, 3)).astype(np.float32)
    d = (aim - o) / np.linalg.norm(aim - o, axis=1, keepdims=True)
    d = d.astype(np.float32)
    tm = rng.uniform(0.5, 8.0, n).astype(np.float32)
    e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    hit, stage = bvh._ray_tri(*(torch.from_numpy(a) for a in (o, d)), 0.001,
                              torch.from_numpy(tm),
                              *(torch.from_numpy(a) for a in (v[:, 0], e1, e2)))
    want = [_scalar_ray_tri(o[i], d[i], np.float32(0.001), tm[i], v[i, 0], e1[i], e2[i])
            for i in range(n)]
    np.testing.assert_array_equal(hit.numpy(), [w[0] for w in want])
    np.testing.assert_array_equal(stage.numpy(), [w[1] for w in want])
    assert set(stage.numpy().tolist()) == {0, 1, 2, 3} and hit.any()


def test_walk_counts_triangle_tests_to_the_first_hit(geo, reference_hits):
    """The plain walk's triangle tests per ray: none for dead rays; for a
    ray that misses, every real triangle of every leaf it pops; for a ray
    that hits, fewer once it stops at a leaf's first hit, which ran the
    whole test. The ragged last leaf holds num_tris % 16 triangles."""
    idx, pos, _, got = geo
    (o, d, tm), ref = reference_hits
    rays = bvh_packet.ray_planes(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tm))
    table = bvh_packet.packet_walk_table(got, torch.from_numpy(idx), torch.from_numpy(pos))
    hit, _, leaf, tests = bvh.occlusion_walk(got, table, rays)
    np.testing.assert_array_equal(hit.numpy(), ref)
    total = tests.sum(dim=1)
    ragged = got.num_tris % bvh.LEAF_TRIS
    assert ragged and int(total[torch.from_numpy(tm == 0)].sum()) == 0
    miss = ~hit & (leaf > 0)
    full = bvh.LEAF_TRIS * leaf
    assert bool(((total == full) | (total == full - bvh.LEAF_TRIS + ragged))[miss].all())
    assert bool((total[hit] <= full[hit]).all()) and bool((tests[hit, 3] >= 1).all())
    assert bool((total[hit] < full[hit] - bvh.LEAF_TRIS + ragged).any())
    assert int(tests[:, :3].sum()) > 0
