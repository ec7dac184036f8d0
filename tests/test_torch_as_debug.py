"""The port's AS-debug caster vs the JAX package's.

- ``trace_closest_plain`` (the closest-hit kernel's plain version) against
  the reference's ``trace_rays(any_hit=False, alpha_test_fn=...)`` on
  numpy-seeded rays over a low-detail dragon and over the stress scene
  (its alpha-clip leaf cards), both walks over the reference's own BVH
  and world positions, with the reference caster's alpha test on each
  side: ``hit`` and ``tri_id`` equal on every ray, ``t`` within a
  relative 1e-5, and ``u``, ``v`` within 1e-5 on >= 99% of the rays and
  within 5e-4 on all: the two walks round alike, but the reference's
  compiler may contract or reorder the three-term products, and a thin
  triangle's small determinant magnifies that last-bit difference in u
  and v (measured: at most 1.5e-4 on 9 of 4096 rays).
- ``render_as_debug_frame`` against the reference's on
  tests/test_as_debug.py's clip-quad scene at 64x64 and on the stress
  scene at 128x72: the linear images within RMSE 1e-4 (the inverse view
  comes from two different 4x4 inverses, so an edge pixel may pick its
  neighbour triangle); the stress frame also meets tests/goldens/
  as_debug.png at the goldens' sRGB RMSE bound 4e-3.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from transmission_renderer_tpu.config import BUCKET_ALPHA_CLIP, BUCKET_OPAQUE
from transmission_renderer_tpu.config import RenderConfig as JConfig
from transmission_renderer_tpu.models import procedural as jproc
from transmission_renderer_tpu.ops import bvh as jbvh
from transmission_renderer_tpu.ops.texture import WRAP_REPEAT as JWRAP
from transmission_renderer_tpu.ops.texture import sample_texture as jsample
from transmission_renderer_tpu.render import make_frame_params as jparams
from transmission_renderer_tpu.render.raytrace import render_as_debug_frame as jcast
from transmission_renderer_tpu.scene.builder import SceneBuilder as JBuilder
from transmission_renderer_tpu.scene.camera import CameraRig as JRig
from transmission_renderer_tpu.scene.types import Similarity as JSim
from transmission_renderer_tpu.scene.types import similarity_apply as jsim_apply
from golden_defs import GOLDEN_DIR
from transmission_renderer_tpu_torch import bridge
from transmission_renderer_tpu_torch.config import RenderConfig
from transmission_renderer_tpu_torch.ops import bvh as pbvh
from transmission_renderer_tpu_torch.ops.bvh_closest import alpha_clip_inputs, trace_closest
from transmission_renderer_tpu_torch.ops.bvh_packet import kernel_walk_table, ray_planes
from transmission_renderer_tpu_torch.render.raytrace import render_as_debug_frame
from transmission_renderer_tpu_torch.scene.textures import linear_to_srgb
from transmission_renderer_tpu_torch.utils.png import read_png

torch.set_num_threads(1)

CPU = "cpu"
T_MIN, T_MAX = 0.01, 1000.0
T_RTOL = 1e-5
UV_TOL, UV_FRAC, UV_MAX = 1e-5, 0.99, 5e-4
MAX_RMSE = 1e-4


def _port_bvh(jb) -> pbvh.BVH:
    """The reference's BVH as the port's (same arrays and layout)."""
    return pbvh.BVH(
        node_boxes=torch.from_numpy(np.array(jb.node_boxes)),
        leaf_tri=torch.from_numpy(np.array(jb.leaf_tri)),
        level_offsets=tuple(jb.level_offsets), level_counts=tuple(jb.level_counts),
        num_tris=jb.num_tris, num_leaves=jb.num_leaves,
    )


def _jalpha_test(scene, tri_vertices, tri_material, uvs):
    """The reference caster's alpha test (render/raytrace.py::as_debug_view)."""
    m = scene.materials

    def alpha_test(tri_id, u, v):
        mid = tri_material[tri_id]
        tid = m.tex_diffuse[mid]
        vidx = tri_vertices[tri_id]
        uv = (uvs[vidx[..., 0]] * (1.0 - u - v)[..., None]
              + uvs[vidx[..., 1]] * u[..., None] + uvs[vidx[..., 2]] * v[..., None])
        sample = jsample(scene.atlas_texels, scene.atlas_meta, scene.atlas_srgb,
                         jnp.maximum(tid, 0), uv, jnp.zeros_like(u), JWRAP,
                         trilinear=False)
        alpha = m.diffuse_factor[mid, 3] * jnp.where(tid >= 0, sample[..., 3], 1.0)
        return alpha >= m.alpha_clipping_cutoff[mid]

    return alpha_test


def _world(scene, dl):
    inst = JSim(translation=scene.inst_transform.translation[dl.vtx_inst],
                scale=scene.inst_transform.scale[dl.vtx_inst],
                rotation=scene.inst_transform.rotation[dl.vtx_inst])
    return jsim_apply(inst, scene.positions[dl.vtx_src]), scene.uvs[dl.vtx_src]


def _seeded_rays(world, n, seed):
    """Rays from points around the scene's bounds towards random points
    inside them (most hit something; some start inside the bounds)."""
    rng = np.random.default_rng(seed)
    w = np.asarray(world)
    lo, hi = w.min(0), w.max(0)
    ext = hi - lo
    origins = (lo + rng.uniform(-0.3, 1.3, (n, 3)) * ext).astype(np.float32)
    targets = (lo + rng.uniform(0.1, 0.9, (n, 3)) * ext).astype(np.float32)
    d = targets - origins
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return origins, d.astype(np.float32)


def _scene_cases():
    return {
        "dragon": lambda: jproc.build_dragon_scene(stacks=24, sectors=48),
        "stress": lambda: jproc.build_stress_scene(grid=2),
    }


@pytest.fixture(scope="module", params=sorted(_scene_cases()))
def walk_pair(request):
    """(reference walk outputs, port walk outputs, stress flag) on 4096
    seeded rays."""
    jb = _scene_cases()[request.param]()
    scene, dl, flags = jb.finish_bundle()
    bvh = jb.build_rt_bvh()
    world, uvs = _world(scene, dl)
    o, d = _seeded_rays(world, 4096, seed=7)
    ref = jbvh.trace_rays(bvh, dl.tri_vtx, world, jnp.asarray(o), jnp.asarray(d),
                          t_min=T_MIN, t_max=T_MAX,
                          alpha_test_fn=_jalpha_test(scene, dl.tri_vtx, dl.tri_material, uvs))
    ref = [np.asarray(a) for a in ref]
    pscene = _port_inputs(scene, dl, flags)[0]
    tri_vtx = torch.from_numpy(np.array(dl.tri_vtx))
    tri_mat = torch.from_numpy(np.array(dl.tri_material))
    pworld = torch.from_numpy(np.array(world))
    puvs = torch.from_numpy(np.array(uvs))
    tree = _port_bvh(bvh)
    table = kernel_walk_table(tree, tri_vtx, pworld)
    rays = ray_planes(torch.from_numpy(o), torch.from_numpy(d), T_MAX)
    alpha = alpha_clip_inputs(pscene, tri_vtx, puvs, tri_mat)
    got = [a.numpy() for a in trace_closest(tree, table, rays, T_MIN, alpha)]
    walk = pbvh.closest_walk(tree, table, rays, T_MIN, alpha.test)
    return ref, got, request.param, walk


def _port_inputs(scene, dl, flags, params=None, lights=None):
    """The reference's frame inputs carried into the port on the CPU."""
    from transmission_renderer_tpu.pbr.lights import pack_lights, point_light

    if params is None:
        params = jparams(JConfig(width=64, height=64), np.eye(4, dtype=np.float32),
                         np.zeros(3, np.float32), np.array([0, 1, 0], np.float32))
    if lights is None:
        lights = pack_lights([point_light([0.0, 1.0, 0.0], [1.0, 1.0, 1.0], 1.0)])
    host = (jax.tree_util.tree_map(np.asarray, x) for x in (scene, dl, params, lights))
    return bridge.from_jax_arrays(*host, flags, device=CPU)


def test_closest_walk_matches_reference(walk_pair):
    ref, got, name, _ = walk_pair
    hit_r, t_r, tri_r, u_r, v_r = ref
    hit_p, t_p, tri_p, u_p, v_p = got
    assert hit_r.sum() > 1000, name
    np.testing.assert_array_equal(hit_p, hit_r)
    np.testing.assert_array_equal(tri_p, tri_r)
    np.testing.assert_allclose(t_p, t_r, rtol=T_RTOL, atol=0)
    for got_c, ref_c in ((u_p, u_r), (v_p, v_r)):
        d = np.abs(got_c - ref_c)
        assert np.mean(d <= UV_TOL) >= UV_FRAC and d.max() <= UV_MAX, (name, d.max())


def test_closest_walk_counts(walk_pair):
    """The plain walk's counts: every live ray pops, leaves test all their
    real slots, and the stress scene's alpha test rejects candidates."""
    _, got, name, walk = walk_pair
    hit, t, tri, u, v, inner, leaf, tests, alphas = walk
    assert torch.equal(hit, torch.from_numpy(got[0]))
    assert bool((inner > 0).all())
    assert int(tests.sum()) <= int(leaf.sum()) * pbvh.LEAF_TRIS
    assert int(alphas.sum()) >= int(hit.sum())
    if name == "stress":
        assert int(alphas.sum()) > int(hit.sum())


def _clip_quad_builders():
    """tests/test_as_debug.py's scene in both packages: a quad whose left
    texels are transparent (alpha 0) in front of a green plane."""
    from transmission_renderer_tpu_torch.config import BUCKET_ALPHA_CLIP as P_CLIP
    from transmission_renderer_tpu_torch.config import BUCKET_OPAQUE as P_OPAQUE
    from transmission_renderer_tpu_torch.models.procedural import make_plane_mesh
    from transmission_renderer_tpu_torch.scene.builder import SceneBuilder

    out = []
    for builder, plane, clip, opaque in ((JBuilder(), jproc.make_plane_mesh, BUCKET_ALPHA_CLIP,
                                          BUCKET_OPAQUE),
                                         (SceneBuilder(), make_plane_mesh, P_CLIP, P_OPAQUE)):
        tex = np.zeros((8, 8, 4), np.uint8)
        tex[:, 4:] = (255, 0, 0, 255)
        clip_mat = builder.add_material(tex_diffuse=builder.add_texture(tex, srgb=True),
                                        alpha_clipping_cutoff=0.5)
        back_mat = builder.add_material(diffuse_factor=(0.0, 1.0, 0.0, 1.0))
        pos, nrm, uv, idx = plane(2.0)
        p_quad = builder.add_primitive(pos, nrm, uv, idx, bucket=clip)
        p_back = builder.add_primitive(pos, nrm, uv, idx, bucket=opaque)
        rot = np.array([np.sin(np.pi / 4), 0, 0, np.cos(np.pi / 4)], np.float32)
        builder.add_instance(p_quad, clip_mat, translation=(0, 0, -2.0), rotation=rot)
        builder.add_instance(p_back, back_mat, translation=(0, 0, -4.0), rotation=rot)
        out.append(builder)
    return out


def _stress_builders():
    from transmission_renderer_tpu_torch.models.procedural import build_stress_scene

    return jproc.build_stress_scene(grid=2), build_stress_scene(grid=2)


FRAMES = {
    # name: (builders, width, height, camera position, pitch)
    "clip_quad": (_clip_quad_builders, 64, 64, (0.0, 0.0, 1.0), 0.0),
    "stress": (_stress_builders, 128, 72, (0.0, 3.0, 2.5), -0.5),
}


@pytest.fixture(scope="module", params=sorted(FRAMES))
def frame_pair(request):
    """(reference image, port image, name) of one AS-debug frame, each
    package from its own builder, BVH and frame params."""
    from functools import partial

    from transmission_renderer_tpu_torch.render.frame import make_frame_params
    from transmission_renderer_tpu_torch.scene.camera import CameraRig

    builders, w, h, cam, pitch = FRAMES[request.param]
    jb, pb = builders()
    jcfg = JConfig(width=w, height=h, ray_traced_shadows=True)
    pcfg = RenderConfig(width=w, height=h, ray_traced_shadows=True)
    jr, pr = JRig(), CameraRig()
    for rig in (jr, pr):
        rig.camera.position = np.array(cam, np.float32)
        rig.camera.pitch = pitch
    scene, dl, _ = jb.finish_bundle()
    ref = np.asarray(jax.jit(partial(jcast, config=jcfg, bvh=jb.build_rt_bvh()))(
        scene, dl, jparams(jcfg, jr.camera.view_matrix(), jr.camera.position, jr.sun_dir()),
        None))
    pscene, pdl, _ = pb.finish_bundle(device=CPU)
    params = make_frame_params(pcfg, pr.camera.view_matrix(), pr.camera.position, pr.sun_dir(),
                               device=CPU)
    got = render_as_debug_frame(pscene, pdl, params, None, pcfg,
                                pb.build_rt_bvh(device=CPU)).numpy()
    return ref, got, request.param


def test_as_debug_frame_matches_reference(frame_pair):
    ref, got, name = frame_pair
    assert got.shape == ref.shape and np.isfinite(got).all()
    rmse = float(np.sqrt(np.mean((got - ref) ** 2)))
    assert rmse <= MAX_RMSE, (name, rmse)
    if name == "clip_quad":
        # the caster sees the green plane through the clipped texels
        h, w = got.shape[:2]
        sides = {tuple((got[h // 2, x] > 0.25).tolist()) for x in (w // 4, 3 * w // 4)}
        assert sides == {(True, False, False), (False, True, False)}, sides
    else:
        # tests/goldens/as_debug.png is the reference's stress frame
        # (golden_defs.py::render_as_debug_golden); the goldens' bound
        golden = read_png(os.path.join(GOLDEN_DIR, "as_debug.png"))[..., :3] / 255.0
        srgb = linear_to_srgb(np.clip(got, 0.0, 1.0))
        assert float(np.sqrt(np.mean((srgb - golden) ** 2))) < 4e-3

