"""The bench's other scenes: the port's builders and lights vs the JAX
package's, and the frame pairs that tests/test_torch_bench_helmet.py,
tests/test_torch_bench_bindless.py and
tests/test_torch_bench_transmissive.py hold.

Builders: build_test_scene, build_opaque_scene, build_attenuation_scene
and build_bindless_scene at their default sizes (the bench's) freeze the
reference's arrays (ints and floats equal, the bfloat16 atlas bit-equal,
so the atlas texels and meta of 72 mixed-size images too) with the same
SceneFlags; spot_light and bindless_lights(48) give the reference's
light dicts.

Frames: each scene at the small golden's size and camera
(tests/golden_defs.py GOLDENS; bindless under the bench's 48-light rig)
renders at 128x72 with 8x128 tiles through both packages on the CPU: the
reference on its Pallas branch in interpret mode (CFG_PAL), the port on
its kernel branch through the kernels' plain versions. Tolerances:
linear LDR RMSE < 1e-3 against the reference's frame, every
FrameDiagnostics field equal, and sRGB RMSE < 4e-3 against the scene's
small golden (tests/test_goldens.py's tolerance; bindless under the
golden's own 20-light rig).
"""

import dataclasses
import os
from functools import partial

import jax
import numpy as np
import pytest
import torch

from golden_defs import CFG_PAL, GOLDEN_DIR, GOLDENS, _lights, _rig
from test_torch_stress_frame import _leaves, bits
from transmission_renderer_tpu_torch.models import procedural
from transmission_renderer_tpu_torch.pbr.lights import pack_lights, point_light, spot_light
from transmission_renderer_tpu_torch.render.frame import make_frame_params, render_frame
from transmission_renderer_tpu_torch.scene.textures import linear_to_srgb
from transmission_renderer_tpu_torch.utils.png import read_png

# torch runs single-threaded here: the suite runs in several worker
# processes at once, and oversubscribed OpenMP threads stall each other
torch.set_num_threads(1)

# name -> (builder name, its keyword arguments, the golden it is held to
# or None, the config's changes to CFG_PAL). The bench's block caps
# (0.625 helmet, 0.8125 bindless) overflow at 128x72, where the floor
# fills most of the 72 blocks: the block-sparse opaque shade runs here
# with a cap of every block, and at the bench's caps on the card
# (chip_smoke.py phase 10). The transmissive scenes lower the 256-tile
# floor so that the transmissive raster feeds the shade through the
# fused sparse path, as at 1080p.
FUSED = {"sparse_raster_tile_floor": 1, "transmission_tile_cap_frac": 0.85}
SCENES = {
    "test_scene": ("build_test_scene", {}, "test_scene", {}),
    "helmet": ("build_opaque_scene", {"stacks": 32, "sectors": 64}, "helmet",
               {"opaque_block_cap_frac": 1.0}),
    "bindless": ("build_bindless_scene", {"grid": 5, "n_images": 48}, "bindless",
                 {"opaque_block_cap_frac": 1.0}),
    "smooth": ("build_dragon_scene", {"stacks": 40, "sectors": 80, "roughness_override": 0.0},
               None, FUSED),
    "attenuation": ("build_attenuation_scene", {}, "attenuation", FUSED),
}
# the small goldens' cameras (the smooth dragon takes the dragon's)
CAMS = {name: GOLDENS[name][1:3] for name in GOLDENS}
CAMS["smooth"] = CAMS["dragon"]


def config(name: str):
    return dataclasses.replace(CFG_PAL, **SCENES[name][3])


def light_dicts(name: str, port: bool, n_bindless: int = 48) -> list:
    """The scene's lights as dicts of the port (or the reference): the
    bench's bindless rig, or golden_defs._lights' one point light."""
    if name == "bindless":
        if port:
            return procedural.bindless_lights(n_bindless)
        from transmission_renderer_tpu.models import bindless_lights

        return bindless_lights(n_bindless)
    return [point_light([0.0, 0.8, 0.0], [1, 0, 0], 5.0)]


def builders(name: str):
    """(the reference's builder, the port's) of scene ``name``."""
    from transmission_renderer_tpu import models

    fn, kw = SCENES[name][:2]
    return getattr(models, fn)(**kw), getattr(procedural, fn)(**kw)


def handles() -> tuple:
    """The kernel branch's four kernel handles."""
    from transmission_renderer_tpu_torch.ops import raster_gbuf, tap_finish
    from transmission_renderer_tpu_torch.render import shade_kernel

    return (raster_gbuf.KERNEL, tap_finish.TAP_KERNEL, shade_kernel.KERNEL,
            tap_finish.FETCH_KERNEL)


def render_pair(name: str) -> dict:
    """Scene ``name`` through both packages: {"ref", "ref_diag", "img",
    "diag", "calls": the port's recorded kernel calls by kernel name,
    "port": (scene, draw list, flags, params), "cfg"}."""
    from transmission_renderer_tpu.pbr.lights import pack_lights as jpack
    from transmission_renderer_tpu.render import make_frame_params as jparams
    from transmission_renderer_tpu.render import render_frame as jrender

    cfg = config(name)
    jb, pb = builders(name)
    scene, dl, flags = jb.finish_bundle()
    rig = _rig(*CAMS[name])
    params = jparams(cfg, rig.camera.view_matrix(), rig.camera.position, rig.sun_dir())
    jlights = jpack(light_dicts(name, port=False)) if name == "bindless" else _lights()
    ref_img, ref_diag = jax.jit(partial(jrender, config=cfg, flags=flags,
                                        return_diagnostics=True))(scene, dl, params, jlights)
    pscene, pdl, pflags = pb.finish_bundle(device="cpu")
    pparams = make_frame_params(cfg, rig.camera.view_matrix(), rig.camera.position,
                                rig.sun_dir(), device="cpu")
    for h in handles():
        h.recorder = []
    try:
        img, diag = render_frame(pscene, pdl, pparams,
                                 pack_lights(light_dicts(name, port=True), device="cpu"), cfg,
                                 flags=pflags, return_diagnostics=True)
        calls = {h.name: h.recorder for h in handles()}
    finally:
        for h in handles():
            h.recorder = None
    return {"ref": np.asarray(ref_img), "ref_diag": jax.tree_util.tree_map(np.asarray, ref_diag),
            "img": img.numpy(), "diag": diag, "calls": calls,
            "port": (pscene, pdl, pflags, pparams), "cfg": cfg}


def check_image(pair) -> None:
    """Linear LDR RMSE < 1e-3 against the reference's frame."""
    ref, got = pair["ref"], pair["img"]
    assert got.shape == ref.shape == (72, 128, 3)
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    rmse = float(np.sqrt(np.mean((got - ref) ** 2)))
    print(f"linear LDR RMSE {rmse:.3g}, max abs {np.abs(got - ref).max():.3g}")
    assert rmse < 1e-3


def check_diagnostics(pair) -> None:
    """Every FrameDiagnostics field equal to the reference's, and no
    capacity overflow."""
    ref, got = pair["ref_diag"], pair["diag"]
    for f in ref._fields:
        r, g = getattr(ref, f), getattr(got, f)
        if isinstance(r, tuple):
            assert tuple(int(x) for x in g) == tuple(int(x) for x in r), f
        else:
            assert int(g) == int(r), f
    assert not got.overflowed() and not bool(ref.overflowed())


def golden_rmse(name: str, img: np.ndarray) -> float:
    """sRGB RMSE of a linear LDR frame against the scene's small golden."""
    golden = read_png(os.path.join(GOLDEN_DIR, f"{SCENES[name][2]}.png"))[..., :3] / 255.0
    return float(np.sqrt(np.mean((linear_to_srgb(img) - golden) ** 2)))


# ---------------------------------------------------------------------------
# the builders and the lights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["build_test_scene", "build_opaque_scene",
                                "build_attenuation_scene", "build_bindless_scene"])
def test_builder_matches_reference(fn):
    """finish_bundle(): the scene (atlas texels as bf16 bit patterns, its
    meta), the draw list and the flags equal the reference's."""
    from transmission_renderer_tpu import models
    from transmission_renderer_tpu.ops.texture import atlas_classes as jclasses
    from transmission_renderer_tpu_torch.ops.texture import atlas_classes

    ref_scene, ref_dl, ref_flags = getattr(models, fn)().finish_bundle()
    scene, dl, flags = getattr(procedural, fn)().finish_bundle(device="cpu")
    for ref, got in ((ref_scene, scene), (ref_dl, dl)):
        ref_leaves, got_leaves = dict(_leaves(ref)), dict(_leaves(got))
        assert set(ref_leaves) == set(got_leaves)
        for name, a in ref_leaves.items():
            np.testing.assert_array_equal(bits(got_leaves[name]), bits(a), err_msg=name)
    assert tuple(flags) == tuple(ref_flags)
    assert atlas_classes(scene.atlas_meta) == jclasses(ref_scene.atlas_meta)
    if fn == "build_bindless_scene":
        # 72 images of six sizes, three not a power of two; no shared bundle
        sizes = {tuple(r) for r in scene.atlas_meta[:, 2:4].tolist()}
        assert sizes == {(s, s) for s in (32, 48, 64, 96, 128, 192)}
        assert scene.atlas_meta.shape[0] == 72 and scene.materials.roughness_factor.numel() == 82
        assert flags.slot_bundles == () and not flags.atlas_pot
    if fn == "build_opaque_scene":
        # a 4-layer bundle beside 1-layer images: classes 1 and 4
        assert atlas_classes(scene.atlas_meta) == (1, 4)
    if fn == "build_attenuation_scene":
        assert flags.has_transmission and flags.transmission_ior_roughness == (0.0,)


def test_spot_light_matches_reference():
    """spot_light's dict, the cone's epsilon from float64 cosines."""
    from transmission_renderer_tpu.pbr.lights import spot_light as jspot

    args = ([1.5, 4.0, -6.0], [0.3, 0.9, 0.5], 12.0, [0.0, -1.0, 0.0], 0.3, 0.8)
    got, ref = spot_light(*args), jspot(*args)
    assert got.keys() == ref.keys()
    for k in ref:
        assert np.asarray(got[k]).dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["spot_epsilon"] == np.float32(np.cos(0.3) - np.cos(0.8))


@pytest.mark.parametrize("n", [48, 20])
def test_bindless_lights_match_reference(n):
    """bindless_lights(n): n - 4 point lights then 4 spot lights, every
    field equal to the reference's, and the packed table equal."""
    from transmission_renderer_tpu.models import bindless_lights as jlights
    from transmission_renderer_tpu.pbr.lights import pack_lights as jpack

    got, ref = procedural.bindless_lights(n), jlights(n)
    assert len(got) == len(ref) == n
    for g, r in zip(got, ref):
        for k in r:
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
    packed, jpacked = pack_lights(got, device="cpu"), jpack(ref)
    for f in jpacked._fields:
        np.testing.assert_array_equal(getattr(packed, f).numpy(),
                                      np.asarray(getattr(jpacked, f)), err_msg=f)
    assert int(packed.is_a_spotlight().sum()) == 4


def test_card_checks_the_same_small_frames():
    """chip_smoke.py phase 10 holds the card's 128x72 frames to the small
    goldens at the scene sizes, cameras and config changes these tests
    use, and its 1080p frames take the bench's block caps, as the 1080p
    goldens of tests/test_torch_bench_hd.py."""
    from test_torch_bench_hd import reference_inputs, smoke_module

    smoke = smoke_module()
    for name, spec in smoke.BENCH_SCENES.items():
        fn, kw, golden, changes = SCENES[name]
        assert spec["builder"] == fn
        if spec["small"] is None:
            assert golden is None
        else:
            args, cam, pitch, small_changes = spec["small"]
            assert dict(spec["args"], **args) == kw and (cam, pitch) == CAMS[name]
            assert small_changes == changes and golden == name
        cfg = reference_inputs(name)[0]
        for key, value in spec["config"].items():
            assert getattr(cfg, key) == value
        assert (cfg.opaque_block_cap_frac is None) == ("opaque_block_cap_frac" not in
                                                       spec["config"])
