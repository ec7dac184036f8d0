"""The 1080p references of the bench's other scenes.

tests/goldens/{helmet,smooth,attenuation,bindless}_hd.png are the JAX
package's own frames of bench.py's scenes at the bench's config for each
(bench.py:275-293), camera (bench.py:86-90, the CameraRig's default sun)
and lights (bench.py:93-99; bindless_lights(48) for bindless), rendered
on the CPU, where the reference takes its visibility-buffer branch
(materialised bins keeping 2048 triangles a tile). chip_smoke.py phase 10
holds the port's kernel-branch frames to them, outside the tiles whose
bins that branch overflowed (BENCH_HD[name]["dropped_tiles"]), and pins
the reference's FrameDiagnostics of each golden frame.

The `slow` test re-renders each golden with the JAX package (10-25 s
and 4-7 GB a scene on 8 CPU cores) and holds it to the stored PNG, the pinned
diagnostics and the dropped tiles recounted from the reference's own
bins:

    python -m pytest tests/test_torch_bench_hd.py -m slow

Regenerating a golden (writes the PNG, prints the diagnostics and the
dropped tiles to pin in chip_smoke.py):

    python tests/test_torch_bench_hd.py helmet smooth attenuation bindless
"""

import importlib.util
import os
import sys
import time
from functools import partial

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(HERE, "goldens")
NAMES = ("helmet", "smooth", "attenuation", "bindless")


def smoke_module():
    """The repo's chip_smoke.py, loaded as a module (it pins BENCH_HD)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, os.pardir, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def reference_inputs(name: str):
    """(config, scene, draw list, flags, frame params, lights) of the
    bench scene ``name`` in the JAX package."""
    from transmission_renderer_tpu.config import RenderConfig
    from transmission_renderer_tpu.models import (
        bindless_lights, build_attenuation_scene, build_bindless_scene,
        build_dragon_scene, build_opaque_scene)
    from transmission_renderer_tpu.pbr.lights import pack_lights, point_light
    from transmission_renderer_tpu.render import make_frame_params
    from transmission_renderer_tpu.scene.camera import CameraRig

    builders = {
        "helmet": (build_opaque_scene, {"opaque_block_cap_frac": 0.625}),
        "smooth": (partial(build_dragon_scene, roughness_override=0.0), {}),
        "attenuation": (build_attenuation_scene, {}),
        "bindless": (build_bindless_scene, {"opaque_block_cap_frac": 0.8125}),
    }
    build, caps = builders[name]
    cfg = RenderConfig(width=1920, height=1080, **caps)
    scene, dl, flags = build().finish_bundle()
    rig = CameraRig()
    rig.camera.position = np.array([0.0, 2.2, 1.5], np.float32)
    rig.camera.pitch = -0.25
    params = make_frame_params(cfg, rig.camera.view_matrix(), rig.camera.position,
                               rig.sun_dir())
    if name == "bindless":
        lights = pack_lights(bindless_lights(48))
    else:
        lights = pack_lights([point_light([0.0, 0.8, 0.0], [1.0, 0.0, 0.0], 5.0),
                              point_light([8.0, 0.8, 0.0], [0.0, 1.0, 0.0], 10.0)])
    return cfg, scene, dl, flags, params, lights


def render_bench_hd_golden(name: str):
    """The JAX package's 1080p frame of bench scene ``name`` through its
    CPU default, the visibility-buffer branch -> (sRGB [1080, 1920, 3]
    float, {diagnostic: int or tuple})."""
    import jax

    from transmission_renderer_tpu.render import render_frame
    from transmission_renderer_tpu.scene.textures import linear_to_srgb

    cfg, scene, dl, flags, params, lights = reference_inputs(name)
    ldr, diag = jax.jit(partial(render_frame, config=cfg, flags=flags,
                                return_diagnostics=True))(scene, dl, params, lights)
    diag = {f: tuple(int(x) for x in v) if isinstance(v, tuple) else int(v)
            for f, v in zip(diag._fields, diag)}
    return linear_to_srgb(np.asarray(ldr)), diag


def dropped_tiles(cfg, scene, dl, params) -> tuple:
    """Row-major ids of the tiles whose bins the reference's
    visibility-buffer branch overflows (more than max_tris_per_tile
    triangles of a pass) on a frame of the reference's (scene, draw list,
    frame params) at ``cfg``, counted by its own setup_triangles /
    bin_triangles: where a golden it rendered lost triangles."""
    import jax
    import jax.numpy as jnp

    from transmission_renderer_tpu.config import (
        BUCKET_ALPHA_CLIP, BUCKET_OPAQUE, BUCKET_TRANSMISSION,
        BUCKET_TRANSMISSION_ALPHA_CLIP)
    from transmission_renderer_tpu.ops.cull import bucket_triangle_masks, cull_instances
    from transmission_renderer_tpu.ops.raster import bin_triangles, setup_triangles
    from transmission_renderer_tpu.scene.types import Similarity, similarity_apply
    from transmission_renderer_tpu.utils.platform import f32_matmuls

    @jax.jit
    @f32_matmuls
    def raw_counts(scene, dl, params):
        # the vertex transform of the reference's render_frame (frame.py:985-1002)
        inst_t = Similarity(translation=scene.inst_transform.translation[dl.vtx_inst],
                            scale=scene.inst_transform.scale[dl.vtx_inst],
                            rotation=scene.inst_transform.rotation[dl.vtx_inst])
        pos = similarity_apply(inst_t, scene.positions[dl.vtx_src])
        clip = jnp.concatenate([pos, jnp.ones_like(pos[:, :1])], -1) @ params.proj_view.T
        visible = cull_instances(scene, params.view, params.frustum_x_xz,
                                 params.frustum_y_yz, cfg.z_near)
        out = []
        for buckets in ((BUCKET_OPAQUE, BUCKET_ALPHA_CLIP),
                        (BUCKET_TRANSMISSION, BUCKET_TRANSMISSION_ALPHA_CLIP)):
            mask = bucket_triangle_masks(dl.tri_inst, dl.tri_bucket, visible, buckets)
            setup = setup_triangles(clip, dl.tri_vtx, mask, cfg.width, cfg.height,
                                    cfg.tile_w, cfg.tile_h)
            bins = bin_triangles(setup, cfg.tiles_x, cfg.tiles_y, cfg.max_tiles_per_tri,
                                 cfg.max_tris_per_tile, cfg.max_big_tris)
            out.append(bins.tile_start[1:] - bins.tile_start[:-1])
        return out

    over = set()
    for counts in raw_counts(scene, dl, params):
        over |= set(np.nonzero(np.asarray(counts) > cfg.max_tris_per_tile)[0].tolist())
    return tuple(sorted(over))


@pytest.mark.slow
@pytest.mark.parametrize("name", NAMES)
def test_bench_hd_golden_is_the_references(name):
    """tests/goldens/<name>_hd.png is the reference's own 1080p frame, with
    the diagnostics and dropped tiles chip_smoke.py pins for it."""
    from transmission_renderer_tpu_torch.utils.png import read_png

    pinned = smoke_module().BENCH_HD[name]
    golden = read_png(os.path.join(GOLDEN_DIR, f"{name}_hd.png"))[..., :3] / 255.0
    got, diag = render_bench_hd_golden(name)
    rmse = float(np.sqrt(np.mean((got - golden) ** 2)))
    assert rmse < 4e-3, rmse
    assert diag == pinned["diagnostics"]
    cfg, scene, dl, _, params, _ = reference_inputs(name)
    assert dropped_tiles(cfg, scene, dl, params) == pinned["dropped_tiles"]


def main(names) -> None:
    from transmission_renderer_tpu.utils.platform import force_cpu
    from transmission_renderer_tpu_torch.utils.png import write_png

    force_cpu()
    for name in names:
        t0 = time.perf_counter()
        srgb, diag = render_bench_hd_golden(name)
        path = os.path.join(GOLDEN_DIR, f"{name}_hd.png")
        write_png(path, srgb)
        cfg, scene, dl, _, params, _ = reference_inputs(name)
        print(f"{name}: wrote {os.path.relpath(path)} in {time.perf_counter() - t0:.1f} s; "
              f"diagnostics {diag}; dropped tiles {dropped_tiles(cfg, scene, dl, params)}",
              flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(HERE, os.pardir))
    main(sys.argv[1:] or NAMES)
