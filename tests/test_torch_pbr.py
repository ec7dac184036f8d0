"""Port PBR layer vs the JAX package: cluster AABBs, light assignment
(including the order-preserving 128-light clamp), the Lottes tonemap,
Beer's-law attenuation and the frustum cull.

Inputs come from numpy default_rng seeds and feed both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmission_renderer_tpu.pbr import brdf as jbrdf
from transmission_renderer_tpu.pbr import clustering as jcl
from transmission_renderer_tpu.pbr import tonemap as jtm
from transmission_renderer_tpu.scene.camera import perspective_matrix_reversed
from transmission_renderer_tpu_torch.pbr import brdf, clustering, tonemap

# torch runs single-threaded here: the suite runs in several worker
# processes at once, and oversubscribed OpenMP threads stall each other
torch.set_num_threads(1)

W, H = 1920, 1080


def _inv_proj():
    proj = perspective_matrix_reversed(W, H)
    return np.linalg.inv(proj).astype(np.float32)


def _aabbs():
    coeffs = jcl.cluster_coefficients(0.01, 500.0, 16)
    mn, mx = jcl.write_cluster_data(jnp.asarray(_inv_proj()), (W, H), (24, 16), coeffs)
    return np.asarray(mn), np.asarray(mx)


def test_cluster_coefficients_equal():
    assert tuple(clustering.cluster_coefficients(0.01, 500.0, 16)) == tuple(
        jcl.cluster_coefficients(0.01, 500.0, 16))


def test_write_cluster_data():
    """View-space cluster AABBs: rtol 1e-5 (the [N,4]x[4,4] inverse-
    projection matmul may sum in another order than XLA's)."""
    ref_mn, ref_mx = _aabbs()
    coeffs = clustering.cluster_coefficients(0.01, 500.0, 16)
    mn, mx = clustering.write_cluster_data(torch.from_numpy(_inv_proj()), (W, H),
                                           (24, 16), coeffs)
    assert mn.shape == (24 * 16 * 16, 3)
    np.testing.assert_allclose(mn.numpy(), ref_mn, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mx.numpy(), ref_mx, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_lights,spread,falloff,spot_frac", [
    (7, 6.0, 8.0, 0.3),  # a few point and spot lights
    (40, 10.0, 30.0, 0.3),  # many lights, partial overlap
    (200, 2.0, 1.0e6, 0.0),  # every cluster sees every light: the 128 clamp
    (300, 8.0, 2.0e3, 0.2),  # above 128 in some clusters, mixed
])
def test_assign_lights_to_clusters_exact(n_lights, spread, falloff, spot_frac):
    """Counts and ascending ids exactly equal, spotlights included."""
    rng = np.random.default_rng(n_lights)
    mn, mx = _aabbs()
    pos = rng.uniform(-spread, spread, (n_lights, 3)).astype(np.float32)
    pos[:, 2] -= spread  # mostly in front of the camera
    fall = rng.uniform(0.2, 1.0, n_lights).astype(np.float32) * np.float32(falloff)
    is_spot = rng.uniform(size=n_lights) < spot_frac
    sdir = rng.normal(size=(n_lights, 3)).astype(np.float32)
    sdir /= np.linalg.norm(sdir, axis=1, keepdims=True)
    outer = np.where(is_spot, rng.uniform(0.2, 1.2, n_lights), 0.0).astype(np.float32)
    ref_c, ref_i = jcl.assign_lights_to_clusters(
        jnp.asarray(mn), jnp.asarray(mx), jnp.asarray(pos), jnp.asarray(fall),
        jnp.asarray(is_spot), jnp.asarray(sdir), jnp.asarray(outer), 128)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    c, i = clustering.assign_lights_to_clusters(
        t(mn), t(mx), t(pos), t(fall), t(is_spot), t(sdir), t(outer), 128)
    np.testing.assert_array_equal(c.numpy(), np.asarray(ref_c).astype(np.int64))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i).astype(np.int64))
    if n_lights > 128:
        assert int(c.max()) == 128
    if spot_frac == 0.0 and n_lights > 128:
        # clamped lists keep the 128 lowest ids, ascending
        np.testing.assert_array_equal(i[0].numpy(), np.arange(128))


def test_lottes_tonemap_planes():
    """Tonemap on planes: atol 1e-6 (pow may differ by an ulp)."""
    rng = np.random.default_rng(3)
    planes = rng.exponential(1.5, (3, 64, 96)).astype(np.float32)
    planes[:, :4] = 0.0  # pure black
    planes[0, 4:8] = -1e-3  # negative shading noise
    planes[:, 8:10] *= 40.0  # beyond the max luminance
    ref = jtm.lottes_tonemap_planes(tuple(jnp.asarray(p) for p in planes),
                                    jtm.bake_lottes_params())
    got = tonemap.lottes_tonemap_planes(tuple(torch.from_numpy(p) for p in planes),
                                        tonemap.bake_lottes_params())
    jb = jtm.bake_lottes_params()
    pb = tonemap.bake_lottes_params()
    for f in jb._fields:
        assert np.float32(getattr(jb, f)) == getattr(pb, f), f
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6, rtol=0)


def test_apply_volume_attenuation():
    """Beer's law, with the infinite-distance (no attenuation) case:
    rtol 1e-6 (log/exp ulps)."""
    rng = np.random.default_rng(5)
    light = rng.uniform(0, 3, (500, 3)).astype(np.float32)
    dist = rng.uniform(0, 2, 500).astype(np.float32)
    att = rng.uniform(0.2, 3, 500).astype(np.float32)
    att[::7] = np.inf
    col = rng.uniform(0.1, 1, (500, 3)).astype(np.float32)
    ref = jbrdf.apply_volume_attenuation(*map(jnp.asarray, (light, dist, att, col)))
    got = brdf.apply_volume_attenuation(*map(torch.from_numpy, (light, dist, att, col)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)


def test_cull_and_bucket_masks():
    """Frustum cull + bucket masks on the small dragon: exactly equal."""
    from transmission_renderer_tpu.config import BUCKET_OPAQUE, BUCKET_TRANSMISSION
    from transmission_renderer_tpu.models.procedural import build_dragon_scene as jdragon
    from transmission_renderer_tpu.ops import cull as jcull
    from transmission_renderer_tpu.render import make_frame_params
    from transmission_renderer_tpu.config import RenderConfig
    from transmission_renderer_tpu.scene.camera import CameraRig
    from transmission_renderer_tpu_torch import bridge
    from transmission_renderer_tpu_torch.ops import cull

    scene, dl, flags = jdragon(stacks=12, sectors=24).finish_bundle()
    cfg = RenderConfig(width=256, height=64)
    rig = CameraRig()
    rig.camera.position = np.array([0.0, 2.2, 1.5], np.float32)
    rig.camera.pitch = -0.25
    params = make_frame_params(cfg, rig.camera.view_matrix(), rig.camera.position,
                               rig.sun_dir())
    ref_vis = jcull.cull_instances(scene, params.view, params.frustum_x_xz,
                                   params.frustum_y_yz, cfg.z_near)
    ref_mask = jcull.bucket_triangle_masks(dl.tri_inst, dl.tri_bucket, ref_vis,
                                           (BUCKET_OPAQUE, BUCKET_TRANSMISSION))
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    s, d, p, _, _ = bridge.from_jax_arrays(as_np(scene), as_np(dl), as_np(params),
                                           _one_light(), flags)
    vis = cull.cull_instances(s, p.view, p.frustum_x_xz, p.frustum_y_yz, cfg.z_near)
    mask = cull.bucket_triangle_masks(d.tri_inst, d.tri_bucket, vis,
                                      (BUCKET_OPAQUE, BUCKET_TRANSMISSION))
    np.testing.assert_array_equal(vis.numpy(), np.asarray(ref_vis))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    fx, fy = cull.frustum_planes_from_projection(perspective_matrix_reversed(256, 64))
    jfx, jfy = jcull.frustum_planes_from_projection(perspective_matrix_reversed(256, 64))
    np.testing.assert_array_equal(fx, jfx)
    np.testing.assert_array_equal(fy, jfy)


def _one_light():
    from transmission_renderer_tpu.pbr.lights import pack_lights, point_light

    return jax.tree_util.tree_map(
        np.asarray, pack_lights([point_light([0.0, 0.8, 0.0], [1, 0, 0], 5.0)]))
