"""The port's four CUDA kernels vs their plain PyTorch versions, on the
card, at small shapes. Marked ``cuda``: on a host without a CUDA device
they skip (the check runs inside the fixture, never at import).

Run on a machine with the card (which has no JAX, so skip the suite's
conftest.py, which imports it):
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The full-size check of the same kernels is chip_smoke.py."""

import numpy as np
import pytest
import torch

from transmission_renderer_tpu.config import RenderConfig

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
    from transmission_renderer_tpu.config import BUCKET_OPAQUE
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


@pytest.fixture(scope="module", params=sorted(SCENES))
def captured(request):
    """One small frame of a scene on the card, every kernel call recorded."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels build with nvcc for sm_90a)")
    from transmission_renderer_tpu_torch.ops import raster_gbuf, tap_finish
    from transmission_renderer_tpu_torch.pbr.lights import pack_lights, point_light
    from transmission_renderer_tpu_torch.render import shade_kernel
    from transmission_renderer_tpu_torch.render.frame import make_frame_params, render_frame
    from transmission_renderer_tpu_torch.scene.camera import CameraRig

    dev = torch.device("cuda")
    scene, dl, flags = SCENES[request.param]().finish_bundle(device=dev)
    cfg = RenderConfig(width=256, height=144, sparse_raster_tile_floor=1)
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
    handles = (raster_gbuf.KERNEL, tap_finish.TAP_KERNEL, shade_kernel.KERNEL,
               tap_finish.FETCH_KERNEL)
    for h in handles:
        h.recorder = []
        h.launches = 0
    img = render_frame(scene, dl, params, lights, cfg, flags)
    torch.cuda.synchronize()
    out = {h.name: (h.recorder, h.launches) for h in handles}
    for h in handles:
        h.recorder = None
    return request.param, img, out


def test_frame_launches_every_kernel(captured):
    name, img, out = captured
    glass = name == "dragon"  # the only scene with a transmissive pass
    assert {n: launches for n, (_, launches) in out.items()} == {
        "raster_gbuf": 1 + glass, "tap_finish": 1, "shade": 1 + glass,
        "transmission_fetch": int(glass)}
    assert bool(torch.isfinite(img).all())


@pytest.mark.parametrize("name", ["raster_gbuf", "tap_finish", "shade",
                                  "transmission_fetch"])
def test_kernel_matches_plain(captured, name):
    """Each recorded call through the kernel and the plain version, with
    chip_smoke.py's tolerances: raster tri/material exact, depth 1e-7,
    attributes atol 1e-4 / rtol 1e-3; tap and fetch 1e-6; shade 1e-5 on
    all but 0.05% of the pixels."""
    from transmission_renderer_tpu_torch.ops import raster_gbuf, tap_finish
    from transmission_renderer_tpu_torch.render import shade_kernel

    handle = {h.name: h for h in (raster_gbuf.KERNEL, tap_finish.TAP_KERNEL,
                                  shade_kernel.KERNEL, tap_finish.FETCH_KERNEL)}[name]
    calls, _ = captured[2][name]
    if not calls:
        assert name == "transmission_fetch" and captured[0] != "dragon"
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
        g = torch.stack(list(got)).cpu().numpy()
        r = torch.stack(list(ref)).cpu().numpy()
        if name == "shade":
            bad = ~np.isclose(g, r, atol=1e-5, rtol=0, equal_nan=True)
            assert bad.any(axis=0).sum() <= 5e-4 * g.shape[1]
        else:
            np.testing.assert_allclose(g, r, atol=1e-6, rtol=0)
