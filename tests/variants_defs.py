"""Shared set-up of tests/test_torch_variants_*.py: the frame variants of
render_frame that the port renders since the quality flags, textured
transmissive roughness, the dense transmission shade, widths that are not
a multiple of 128 and ray-traced shadows on every transmission path were
ported.

Each frame renders through both packages on the CPU at 128x72 (or 200x72)
from the same builders: the reference on its Pallas branch in interpret
mode (tests/golden_defs.py CFG_PAL, with the 256-tile floor lowered so the
fused sparse path runs at this size, as tests/test_torch_frame.py does)
or on its visibility-buffer branch (CFG), the port through its kernels'
plain versions. ``render_pair`` returns both frames, both diagnostics,
the port's recorded kernel calls and both packages' shadow factors.

Tolerances (stated once, used by every variant file): linear LDR RMSE
<= 1e-5 and every FrameDiagnostics field equal; the bf16 frames instead
within a quarter of the reference's own bf16-vs-exact RMSE.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np

from golden_defs import CFG, CFG_PAL, _lights, _rig
from transmission_renderer_tpu.config import BUCKET_OPAQUE as J_OPAQUE
from transmission_renderer_tpu.config import BUCKET_TRANSMISSION as J_TRANSMISSION
from transmission_renderer_tpu.models import procedural as jproc
from transmission_renderer_tpu.render import make_frame_params as jparams
from transmission_renderer_tpu.render import raytrace as jraytrace
from transmission_renderer_tpu.render import render_frame as jrender
from transmission_renderer_tpu.scene.builder import SceneBuilder as JSceneBuilder
from transmission_renderer_tpu_torch.config import BUCKET_OPAQUE, BUCKET_TRANSMISSION
from transmission_renderer_tpu_torch.models import procedural as pproc
from transmission_renderer_tpu_torch.ops import raster_gbuf, tap_finish
from transmission_renderer_tpu_torch.pbr.lights import pack_lights, point_light
from transmission_renderer_tpu_torch.render import frame as pframe
from transmission_renderer_tpu_torch.render import shade_kernel
from transmission_renderer_tpu_torch.scene.builder import SceneBuilder
from transmission_renderer_tpu_torch.scene.textures import linear_to_srgb

MAX_RMSE = 1e-5
BF16_SHARE = 0.25
# the kernel branch at 128x72 with its fused sparse transmission path
PAL = dataclasses.replace(CFG_PAL, sparse_raster_tile_floor=1, transmission_tile_cap_frac=0.85)
VIS = CFG
DRAGON_CAM = ((0.0, 2.2, 1.5), -0.25)
STRESS_CAM = ((0.0, 3.0, 2.5), -0.5)
HANDLES = {"raster_gbuf": raster_gbuf.KERNEL, "shade": shade_kernel.KERNEL,
           "tap_finish": tap_finish.TAP_KERNEL, "transmission_fetch": tap_finish.FETCH_KERNEL}


def roughness_image(size: int = 64, seed: int = 5) -> np.ndarray:
    """RGBA8 metallic-roughness texture: roughness (G) a smooth wave over
    [0.05, 0.95] with noise, metallic (B) 0, so the glass's lod spans
    most of the pyramid."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size] / size
    g = np.clip(0.5 + 0.45 * np.sin(6.0 * x + 3.0 * y)
                + 0.05 * rng.standard_normal((size, size)), 0.0, 1.0)
    img = np.zeros((size, size, 4), np.uint8)
    img[..., 1] = np.round(g * 255.0).astype(np.uint8)
    img[..., 3] = 255
    return img


def textured_glass_dragon(proc, builder_cls, opaque: int, transmission: int,
                          stacks: int = 40, sectors: int = 80):
    """The small flagship dragon whose glass reads its roughness from a
    metallic-roughness texture, built through ``builder_cls`` (either
    package's public SceneBuilder) from the same numpy arrays."""
    b = builder_cls()
    checker = b.add_texture(proc.checkerboard_texture(512, 12, 230, 40), srgb=True)
    floor_mat = b.add_material(tex_diffuse=checker, roughness_factor=0.7)
    wall_mat = b.add_material(diffuse_factor=(0.35, 0.5, 0.7, 1.0), roughness_factor=0.9)
    rough = b.add_texture(roughness_image(), srgb=False)
    glass = b.add_material(
        diffuse_factor=(1.0, 1.0, 1.0, 1.0), roughness_factor=1.0, metallic_factor=0.0,
        transmission_factor=1.0, thickness_factor=0.6, attenuation_distance=1.0,
        attenuation_colour=(0.9, 0.4, 0.25), index_of_refraction=1.5,
        tex_metallic_roughness=rough)
    p_floor = b.add_primitive(*proc.make_plane_mesh(10.0), bucket=opaque)
    p_wall = b.add_primitive(*proc.make_box_mesh((6.0, 4.0, 0.2)), bucket=opaque)
    p_glass = b.add_primitive(*proc._displaced_sphere(stacks, sectors, amp=0.25),
                              bucket=transmission)
    b.add_instance(p_floor, floor_mat)
    b.add_instance(p_wall, wall_mat, translation=(0.0, 3.0, -7.0))
    b.add_instance(p_glass, glass, translation=(0.0, 1.6, -3.5), scale=1.2)
    return b


def builders(kind: str):
    """(reference builder, port builder, camera) of scene ``kind``."""
    if kind == "dragon":
        return (jproc.build_dragon_scene(stacks=40, sectors=80, roughness_override=0.25),
                pproc.build_dragon_scene(stacks=40, sectors=80, roughness_override=0.25),
                DRAGON_CAM)
    if kind == "helmet":
        return (jproc.build_opaque_scene(stacks=32, sectors=64),
                pproc.build_opaque_scene(stacks=32, sectors=64), DRAGON_CAM)
    if kind == "stress":
        return jproc.build_stress_scene(grid=2), pproc.build_stress_scene(grid=2), STRESS_CAM
    if kind == "textured_glass":
        return (textured_glass_dragon(jproc, JSceneBuilder, J_OPAQUE, J_TRANSMISSION),
                textured_glass_dragon(pproc, SceneBuilder, BUCKET_OPAQUE, BUCKET_TRANSMISSION),
                DRAGON_CAM)
    raise KeyError(kind)


class Scenes:
    """Both packages' frozen scene of one kind, built once."""

    def __init__(self, kind: str, rt: bool = False):
        jb, pb, self.cam = builders(kind)
        self.ref = jb.finish_bundle()
        self.port = pb.finish_bundle(device="cpu")
        self.ref_bvh = jb.build_rt_bvh() if rt else None
        self.port_bvh = pb.build_rt_bvh(device="cpu") if rt else None


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def render_ref(scenes: Scenes, cfg) -> tuple:
    """The reference's jitted frame -> (image, diagnostics, shadow factors)."""
    scene, dl, flags = scenes.ref
    rig = _rig(*scenes.cam)
    params = jparams(cfg, rig.camera.view_matrix(), rig.camera.position, rig.sun_dir())
    factors = []
    real = jraytrace.shadow_factors

    def recorded(*args, **kwargs):
        out = real(*args, **kwargs)
        factors.append(out)
        return out

    def run(scene, dl, params, lights, bvh):
        factors.clear()
        img, diag = jrender(scene, dl, params, lights, config=cfg, flags=flags, bvh=bvh,
                            return_diagnostics=True)
        return img, diag, list(factors)

    jraytrace.shadow_factors = recorded
    try:
        img, diag, fac = jax.jit(run)(scene, dl, params, _lights(), scenes.ref_bvh)
    finally:
        jraytrace.shadow_factors = real
    return np.asarray(img), _np(diag), [_np(f) for f in fac]


def render_port(scenes: Scenes, cfg, record: bool = False) -> dict:
    """The port's frame -> dict(img, hdr, diag, factors: [(sun, lights,
    packet_swizzle)], calls: {kernel: recorded calls})."""
    scene, dl, flags = scenes.port
    rig = _rig(*scenes.cam)
    params = pframe.make_frame_params(cfg, rig.camera.view_matrix(), rig.camera.position,
                                      rig.sun_dir(), device="cpu")
    lights = pack_lights([point_light([0.0, 0.8, 0.0], [1, 0, 0], 5.0)], device="cpu")
    factors = []
    real = pframe.shadow_factors

    def recorded(*args, **kwargs):
        out = real(*args, **kwargs)
        factors.append((out[0].numpy(), out[1].numpy(), kwargs.get("packet_swizzle")))
        return out

    pframe.shadow_factors = recorded
    for h in HANDLES.values():
        h.recorder = [] if record else None
    try:
        img, hdr, diag = pframe.render_frame(scene, dl, params, lights, cfg, flags=flags,
                                             return_hdr=True, return_diagnostics=True,
                                             bvh=scenes.port_bvh)
    finally:
        pframe.shadow_factors = real
        calls = {n: h.recorder for n, h in HANDLES.items()}
        for h in HANDLES.values():
            h.recorder = None
    return dict(img=img.numpy(), hdr=hdr.numpy(), diag=diag, factors=factors, calls=calls)


def render_pair(scenes: Scenes, cfg, record: bool = False) -> dict:
    ref, ref_diag, ref_factors = render_ref(scenes, cfg)
    out = render_port(scenes, cfg, record)
    out.update(ref=ref, ref_diag=ref_diag, ref_factors=ref_factors, cfg=cfg)
    return out


class FrameCache:
    """Frames rendered on first use and kept for the module: the key
    (scene kind, config name) -> render_pair's dict, or render_port's for
    a port-only frame."""

    def __init__(self, configs: dict, rt_kinds=()):
        self.configs = configs
        self.rt_kinds = set(rt_kinds)
        self.scenes = {}
        self.frames = {}

    def scene(self, kind: str) -> Scenes:
        if kind not in self.scenes:
            self.scenes[kind] = Scenes(kind, rt=kind in self.rt_kinds)
        return self.scenes[kind]

    def __call__(self, kind: str, name: str, port_only: bool = False) -> dict:
        key = (kind, name, port_only)
        if port_only and (kind, name, False) in self.frames:
            return self.frames[(kind, name, False)]
        if key not in self.frames:
            cfg = self.configs[name]
            self.frames[key] = (render_port(self.scene(kind), cfg, record=True) if port_only
                                else render_pair(self.scene(kind), cfg, record=True))
        return self.frames[key]


def srgb(img):
    return linear_to_srgb(np.asarray(img))


def rmse(a, b) -> float:
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def check_range(pair) -> None:
    """The reference's shape, finite, in [0, 1]."""
    ref, got, cfg = pair["ref"], pair["img"], pair["cfg"]
    assert got.shape == ref.shape == (cfg.height, cfg.width, 3)
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0


def check_image(pair, max_rmse: float = MAX_RMSE) -> float:
    """check_range, and linear RMSE <= max_rmse against the reference."""
    check_range(pair)
    ref, got = pair["ref"], pair["img"]
    err = rmse(got, ref)
    print(f"linear LDR RMSE {err:.3g}, max abs {np.abs(got - ref).max():.3g}")
    assert err <= max_rmse
    return err


def check_diagnostics(pair) -> None:
    """Every FrameDiagnostics field equal to the reference's."""
    ref, got = pair["ref_diag"], pair["diag"]
    for name in ref._fields:
        r, g = getattr(ref, name), getattr(got, name)
        if isinstance(r, tuple):
            assert tuple(int(x) for x in g) == tuple(int(x) for x in r), name
        else:
            assert int(g) == int(r), name


def check_factors(pair, swizzles: tuple) -> None:
    """Each pass's shadow factors equal the reference's on every ray, and
    the port traced each pass in the ray order ``swizzles`` names."""
    assert len(pair["factors"]) == len(pair["ref_factors"]) == len(swizzles)
    for (sun, light, swz), ref, want in zip(pair["factors"], pair["ref_factors"], swizzles):
        assert swz == want
        for got, r in zip((sun, light), ref):
            assert got.shape == r.shape
            np.testing.assert_array_equal(got, r)
    assert (pair["factors"][0][0] < 1.0).any()
