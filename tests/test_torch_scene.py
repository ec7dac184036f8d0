"""Port host layer vs the JAX package: scene building, the bridge, and a
JAX-free render.

The port's SceneBuilder / build_dragon_scene must freeze exactly the
arrays the reference freezes (build_stress_scene's are held in
tests/test_torch_stress_frame.py, the bench's other builders' in
tests/test_torch_scenes_bench.py) (ints and floats equal, the bfloat16
atlas bit-equal); the bridge must carry the reference's arrays over unchanged;
and the port must build and render with jax, PIL, ml_dtypes and the JAX
package itself absent, as on the machine with the card. The port's own
copies of the reference's JAX-free modules (RenderConfig, the GGX LUT)
must equal them, and its entry points must default to the card.
"""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from transmission_renderer_tpu.models.procedural import (
    build_dragon_scene as jax_build_dragon,
)
from transmission_renderer_tpu.pbr.lights import pack_lights as jax_pack_lights
from transmission_renderer_tpu.pbr.lights import point_light as jax_point_light
from transmission_renderer_tpu.render import make_frame_params as jax_frame_params
from transmission_renderer_tpu_torch import bridge
from transmission_renderer_tpu_torch.models.procedural import build_dragon_scene
from transmission_renderer_tpu_torch.scene.types import to_device

# torch runs single-threaded here: the suite runs in several worker
# processes at once, and oversubscribed OpenMP threads stall each other
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _leaves(tree, prefix=""):
    """(name, leaf) pairs of a nested NamedTuple."""
    if hasattr(tree, "_fields"):
        out = []
        for f in tree._fields:
            out += _leaves(getattr(tree, f), f"{prefix}{f}.")
        return out
    return [(prefix[:-1], tree)]


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.fixture(scope="module")
def both_scenes():
    ref = jax_build_dragon(stacks=40, sectors=80).finish_bundle()
    port = build_dragon_scene(stacks=40, sectors=80).finish_bundle(device="cpu")
    return ref, port


@pytest.mark.parametrize("part", ["scene", "draw_list"])
def test_builder_matches_reference(both_scenes, part):
    """Every field bit-equal (the atlas compared as bf16 bit patterns)."""
    (ref_scene, ref_dl, _), (scene, dl, _) = both_scenes
    ref, got = (ref_scene, scene) if part == "scene" else (ref_dl, dl)
    ref_leaves = dict(_leaves(ref))
    got_leaves = dict(_leaves(got))
    assert set(ref_leaves) == set(got_leaves)
    for name, a in ref_leaves.items():
        a, b = _np(a), _np(got_leaves[name])
        assert a.shape == b.shape, name
        assert a.dtype.itemsize == b.dtype.itemsize, name
        np.testing.assert_array_equal(b, a, err_msg=name)


def test_scene_flags_match_reference(both_scenes):
    (_, _, ref_flags), (_, _, flags) = both_scenes
    assert tuple(flags) == tuple(ref_flags)
    assert flags._fields == ref_flags._fields


def test_bridge_carries_reference_arrays(both_scenes):
    """from_jax_arrays gives the port's builder tensors back exactly."""
    (ref_scene, ref_dl, ref_flags), (scene, dl, flags) = both_scenes
    from transmission_renderer_tpu.config import RenderConfig
    from transmission_renderer_tpu.scene.camera import CameraRig

    cfg = RenderConfig(width=128, height=72)
    rig = CameraRig()
    jparams = jax_frame_params(cfg, rig.camera.view_matrix(), rig.camera.position,
                               rig.sun_dir())
    jlights = jax_pack_lights([jax_point_light([0.0, 0.8, 0.0], [1, 0, 0], 5.0)])
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    b_scene, b_dl, b_params, b_lights, b_flags = bridge.from_jax_arrays(
        as_np(ref_scene), as_np(ref_dl), as_np(jparams), as_np(jlights),
        ref_flags, device="cpu",
    )
    assert b_scene.atlas_texels.dtype == torch.bfloat16
    for (name, a), (_, b) in zip(_leaves(scene), _leaves(b_scene)):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(_np(b), _np(a), err_msg=name)
    for (name, a), (_, b) in zip(_leaves(dl), _leaves(b_dl)):
        np.testing.assert_array_equal(_np(b), _np(a), err_msg=name)
    for name, a in _leaves(jparams):
        np.testing.assert_array_equal(_np(getattr(b_params, name)), np.asarray(a))
    for name, a in _leaves(jlights):
        np.testing.assert_array_equal(_np(getattr(b_lights, name)), np.asarray(a))
    assert b_flags == flags
    # moving the bridged tree keeps its structure
    assert to_device(b_scene, "cpu").materials.num == scene.materials.num


def test_port_runs_without_jax_pil_ml_dtypes():
    """The card machine's environment: jax, PIL and ml_dtypes absent; the
    JAX package blocked too, so an import of it anywhere in the port
    fails here."""
    script = textwrap.dedent("""
        import dataclasses
        import sys
        for name in ("jax", "jaxlib", "PIL", "ml_dtypes", "transmission_renderer_tpu"):
            sys.modules[name] = None
        import numpy as np
        import torch
        torch.set_num_threads(1)
        from transmission_renderer_tpu_torch.config import RenderConfig
        from transmission_renderer_tpu_torch.models.procedural import build_dragon_scene
        from transmission_renderer_tpu_torch.pbr.lights import pack_lights, point_light
        from transmission_renderer_tpu_torch.render.frame import make_frame_params, render_frame
        from transmission_renderer_tpu_torch.scene.camera import CameraRig
        from transmission_renderer_tpu_torch.utils.png import read_png
        builder = build_dragon_scene(stacks=40, sectors=80)
        scene, dl, flags = builder.finish_bundle(device="cpu")
        cfg = RenderConfig(width=128, height=72, sparse_raster_tile_floor=1,
                           transmission_tile_cap_frac=0.85, use_pallas_raster=True)
        rig = CameraRig()
        rig.camera.position = np.array([0.0, 2.2, 1.5], np.float32)
        rig.camera.pitch = -0.25
        params = make_frame_params(cfg, rig.camera.view_matrix(),
                                   rig.camera.position, rig.sun_dir(), device="cpu")
        lights = pack_lights([point_light([0.0, 0.8, 0.0], [1, 0, 0], 5.0)], device="cpu")
        img, hdr, diag = render_frame(scene, dl, params, lights, cfg, flags,
                                      return_hdr=True, return_diagnostics=True)
        assert img.shape == (72, 128, 3) and bool(torch.isfinite(img).all())
        assert not diag.overflowed()
        rt = dataclasses.replace(cfg, ray_traced_shadows=True)
        img_rt, hdr_rt, diag = render_frame(scene, dl, params, lights, rt, flags,
                                            return_hdr=True, return_diagnostics=True,
                                            bvh=builder.build_rt_bvh(device="cpu"))
        assert bool(torch.isfinite(img_rt).all()) and not diag.overflowed()
        # shadows only remove light
        assert bool((hdr_rt <= hdr).all()) and bool((hdr_rt < hdr - 0.05).any())
        # the visibility-buffer branch (the CPU default) with its tensor shade
        vis = dataclasses.replace(cfg, use_pallas_raster=None)
        img_vis, diag = render_frame(scene, dl, params, lights, vis, flags,
                                     return_diagnostics=True)
        assert bool(torch.isfinite(img_vis).all()) and not diag.overflowed()
        assert int(diag.transmission_tiles) == 0 and int(diag.transmission_blocks) > 0
        assert float((img_vis - img).abs().mean()) < 0.01
        # the stress scene: alpha-clip depth peeling on the kernel branch
        from transmission_renderer_tpu_torch.models.procedural import build_stress_scene
        scene, dl, flags = build_stress_scene(grid=2).finish_bundle(device="cpu")
        clip_cfg = dataclasses.replace(cfg, opaque_block_cap_frac=1.0)
        img_clip, diag = render_frame(scene, dl, params, lights, clip_cfg, flags,
                                      return_diagnostics=True)
        assert flags.has_alpha_clip and bool(torch.isfinite(img_clip).all())
        assert len(diag.clip_round_demand) == 3 and int(diag.opaque_blocks) > 0
        assert read_png("tests/goldens/dragon.png").shape == (72, 128, 4)
        loaded = {m.split(".")[0] for m, v in sys.modules.items() if v}
        assert not loaded & {"jax", "transmission_renderer_tpu"}, loaded
        print("OK", float(img.mean()))
    """)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK"), proc.stdout


def test_render_config_matches_reference():
    """The port's own RenderConfig: the same fields, defaults and derived
    properties as the JAX package's, and the same bucket constants."""
    import dataclasses

    from transmission_renderer_tpu import config as jconfig
    from transmission_renderer_tpu_torch import config

    def spec(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert spec(config.RenderConfig) == spec(jconfig.RenderConfig)
    props = ("num_clusters", "framebuffer_size", "tiles_x", "tiles_y", "num_tiles",
             "cluster_size_in_pixels")
    for kw in ({}, dict(width=128, height=72, tile_w=32), dict(width=1000, height=600)):
        got, ref = config.RenderConfig(**kw), jconfig.RenderConfig(**kw)
        assert [getattr(got, p) for p in props] == [getattr(ref, p) for p in props]
    for name in ("BUCKET_OPAQUE", "BUCKET_ALPHA_CLIP", "BUCKET_TRANSMISSION",
                 "BUCKET_TRANSMISSION_ALPHA_CLIP", "NUM_DRAW_BUCKETS", "MAX_IMAGES"):
        assert getattr(config, name) == getattr(jconfig, name), name


@pytest.mark.parametrize("size", [256, 64, None])
def test_ggx_lut_matches_reference(size):
    """The port's copy of the LUT bake, bit for bit."""
    from transmission_renderer_tpu.utils.ggx_lut import default_ggx_lut as jlut
    from transmission_renderer_tpu_torch.utils.ggx_lut import default_ggx_lut

    got, ref = default_ggx_lut(size), jlut(size)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_entry_points_default_to_the_card():
    """Without ``device`` the port puts its tensors on the card; with no
    card it raises instead of carrying on on the CPU."""
    from transmission_renderer_tpu_torch.config import RenderConfig
    from transmission_renderer_tpu_torch.pbr.lights import pack_lights, point_light
    from transmission_renderer_tpu_torch.render.frame import make_frame_params
    from transmission_renderer_tpu_torch.scene.camera import CameraRig

    rig = CameraRig()
    calls = (
        lambda: pack_lights([point_light([0.0, 0.8, 0.0], [1, 0, 0], 5.0)]).position,
        lambda: make_frame_params(RenderConfig(width=128, height=72),
                                  rig.camera.view_matrix(), rig.camera.position,
                                  rig.sun_dir()).proj_view,
    )
    for call in calls:
        if torch.cuda.is_available():
            assert call().is_cuda
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
