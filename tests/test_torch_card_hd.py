"""The port's 1920x1080 frames on the card: each frame's kernel calls
against their plain versions, its launches, image, diagnostics and
golden; the CLI at its defaults; glTF JPEG images; the row-band frames;
pair-stream compaction and the frontier traversal.

Frames (FRAMES): the flagship (tests/golden_defs.py::render_hd_golden's
scene, camera and lights) plain, with ray-traced shadows at full and
half resolution, on the visibility-buffer branch with and without them,
with each quality flag, with a textured glass roughness, with the dense
transmission path and shadows, and at 1600x900; the bench's stress scene
(alpha-clip depth peeling) at its config, with shadows and on the
visibility branch; the bench's helmet, smooth, attenuation and bindless
scenes. Tolerances are card_defs.check_against_plain's: the rasters bit
for bit, kernel 3 within 1e-5 on all but 0.05% of the pixels, kernels 2
and 4 within 1e-6, kernel 5's hit set exact; the goldens sRGB RMSE 4e-3.

Marked ``cuda``: on a host without a CUDA device every test skips. Run on
a machine with the card (which has no JAX, so skip the suite's
conftest.py, which imports it):
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py tests/test_torch_card_hd.py -q
"""

import contextlib
import dataclasses
import functools
import hashlib
import io
import json
import os
import re
from typing import NamedTuple

import numpy as np
import pytest
import torch

import card_defs as cd
from transmission_renderer_tpu_torch.config import RenderConfig

pytestmark = pytest.mark.cuda

HD = RenderConfig(width=1920, height=1080)
VIS = dataclasses.replace(HD, use_pallas_raster=False)
RT = dataclasses.replace(HD, ray_traced_shadows=True)
STRESS = dataclasses.replace(HD, opaque_block_cap_frac=0.8125)
# the flagship's passes: kernel 1 and kernel 3 each, the diffuse tap, the
# refraction fetch; two peels of the default 4 rounds: an alpha test a
# round, a worklist and a merge a re-race round
FLAGSHIP = {"raster_gbuf": 2, "tap_finish": 1, "shade": 2, "transmission_fetch": 1}
PEEL = {"clip_alpha": 8, "clip_worklist": 6, "clip_merge": 6}
KERNELS = ("raster_gbuf", "tap_finish", "shade", "transmission_fetch")
# the quality flags, each with the reference's own pinned bound on the
# frame against the exact one (RMSE): tests/test_e2e.py:93-103 (half-res,
# linear), tests/test_quad_taps.py:36-50 (quad taps, linear),
# tests/test_goldens.py:62-77 (bf16, sRGB), and its CLI flag
FLAG_BOUNDS = {"half_res_refraction": (0.02, "linear", "--half-res-refraction"),
               "quad_material_taps": (0.1, "linear", "--quad-taps"),
               "bf16_light_math": (1e-2, "sRGB", "--bf16-lights")}


class Frame(NamedTuple):
    scene: str  # "flagship", "stress", "textured" or a bench scene
    cfg: RenderConfig | None  # None: the bench scene's own
    launches: dict | None  # None: card_defs.expected_launches
    kernels: tuple  # the kernels whose calls are held to their plain versions
    overflow: str | None = "none"  # "none", "bins", "peel"; None: not held
    golden: tuple | None = None  # (PNG name, dropped tiles or None: the whole frame)
    orders: tuple | None = None  # the shadow-ray orders of its shadow_factors calls


def _flag(flag):
    half = flag == "half_res_refraction"
    return Frame("flagship", dataclasses.replace(HD, **{flag: True}),
                 dict(raster_gbuf=2, tap_finish=int(half), shade=int(half)),
                 ("raster_gbuf",) + ("tap_finish", "shade") * half)


FRAMES = {
    "flagship": Frame("flagship", HD, FLAGSHIP, KERNELS,
                      golden=("dragon_hd", cd.GOLDEN_DROPPED_TILES)),
    "rt": Frame("flagship", RT, dict(FLAGSHIP, bvh_occlusion=2), KERNELS + ("bvh_occlusion",)),
    "rt-half": Frame("flagship", dataclasses.replace(RT, half_res_shadow_rays=True),
                     dict(FLAGSHIP, bvh_occlusion=2), KERNELS + ("bvh_occlusion",), None),
    "vis": Frame("flagship", VIS, dict(raster_vis=2), ("raster_vis",), "bins",
                 ("dragon_hd", None)),
    "vis-rt": Frame("flagship", dataclasses.replace(VIS, ray_traced_shadows=True),
                    dict(raster_vis=2, bvh_occlusion=2), ("raster_vis", "bvh_occlusion"), None,
                    orders=("2d", None)),
    "dense-rt": Frame("flagship", dataclasses.replace(RT, transmission_tile_cap_frac=None,
                                                      transmission_block_cap_frac=None),
                      dict(FLAGSHIP, bvh_occlusion=2), KERNELS + ("bvh_occlusion",), None,
                      orders=("2d", "2d")),
    "1600x900": Frame("flagship", RenderConfig(width=1600, height=900), dict(raster_gbuf=2),
                      ("raster_gbuf",)),
    "textured-roughness": Frame("textured", HD, None, KERNELS),
    "stress": Frame("stress", STRESS, dict(FLAGSHIP, raster_gbuf=10, **PEEL),
                    KERNELS + ("clip_alpha", "clip_peel"), "peel"),
    "stress-rt": Frame("stress", dataclasses.replace(STRESS, ray_traced_shadows=True),
                       dict(FLAGSHIP, raster_gbuf=10, bvh_occlusion=2, **PEEL),
                       KERNELS + ("bvh_occlusion", "clip_alpha", "clip_peel"), None,
                       orders=("2d", None)),
    "stress-vis": Frame("stress", dataclasses.replace(STRESS, use_pallas_raster=False),
                        dict(raster_vis=2), ("raster_vis",), golden=("stress_hd", None)),
    **{name: Frame(name, None, None, KERNELS if name in ("smooth", "attenuation")
                   else KERNELS[:3], golden=(f"{name}_hd", cd.BENCH_HD[name]["dropped_tiles"]))
       for name in cd.BENCH_SCENES},
    **{flag: _flag(flag) for flag in FLAG_BOUNDS},
}


@pytest.fixture(scope="module", autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels build with nvcc for sm_90a)")


DEV = torch.device("cuda")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference's own bound on a row-band frame against the single one
# (tests/sharding_driver.py:108)
SHARDED_MAX_ABS = 2e-6


def golden(name: str) -> np.ndarray:
    """tests/goldens/<name>.png as sRGB floats [H, W, 3]."""
    from transmission_renderer_tpu_torch.utils.png import read_png

    return read_png(os.path.join(ROOT, "tests", "goldens", f"{name}.png"))[..., :3] / 255.0


def srgb_rmse(img, gold, keep=None) -> float:
    """sRGB RMSE of a linear frame (tensor or array) against a golden,
    over the pixels ``keep`` (all by default)."""
    from transmission_renderer_tpu_torch.scene.textures import linear_to_srgb

    img = img.cpu().numpy() if isinstance(img, torch.Tensor) else img
    d = linear_to_srgb(img) - gold
    return float(np.sqrt(np.mean((d if keep is None else d[keep]) ** 2)))


def every_kernel(**launches) -> dict:
    """{kernel name: launches} of every kernel, 0 unless given."""
    return {h.name: launches.get(h.name, 0) for h in cd.all_handles()}


def roughness_image(size: int = 64, seed: int = 5) -> np.ndarray:
    """The glass's metallic-roughness texture of the textured-roughness
    frame (tests/variants_defs.py builds the same): roughness (G) a wave
    over [0.05, 0.95] with noise, metallic (B) 0."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size] / size
    g = np.clip(0.5 + 0.45 * np.sin(6.0 * x + 3.0 * y)
                + 0.05 * rng.standard_normal((size, size)), 0.0, 1.0)
    img = np.zeros((size, size, 4), np.uint8)
    img[..., 1] = np.round(g * 255.0).astype(np.uint8)
    img[..., 3] = 255
    return img


def textured_glass_dragon():
    """The flagship scene (build_dragon_scene at default detail) with a
    metallic-roughness texture on its glass: the transmissive roughness is
    per pixel, so the frame has no static pyramid level set."""
    from transmission_renderer_tpu_torch.config import BUCKET_OPAQUE, BUCKET_TRANSMISSION
    from transmission_renderer_tpu_torch.models import procedural as proc
    from transmission_renderer_tpu_torch.scene.builder import SceneBuilder

    b = SceneBuilder()
    checker = b.add_texture(proc.checkerboard_texture(512, 12, 230, 40), srgb=True)
    floor_mat = b.add_material(tex_diffuse=checker, roughness_factor=0.7)
    wall_mat = b.add_material(diffuse_factor=(0.35, 0.5, 0.7, 1.0), roughness_factor=0.9)
    glass = b.add_material(
        diffuse_factor=(1.0, 1.0, 1.0, 1.0), roughness_factor=1.0, metallic_factor=0.0,
        transmission_factor=1.0, thickness_factor=0.6, attenuation_distance=1.0,
        attenuation_colour=(0.9, 0.4, 0.25), index_of_refraction=1.5,
        tex_metallic_roughness=b.add_texture(roughness_image(), srgb=False))
    p_floor = b.add_primitive(*proc.make_plane_mesh(10.0), bucket=BUCKET_OPAQUE)
    p_wall = b.add_primitive(*proc.make_box_mesh((6.0, 4.0, 0.2)), bucket=BUCKET_OPAQUE)
    p_glass = b.add_primitive(*proc._displaced_sphere(180, 360, amp=0.25),
                              bucket=BUCKET_TRANSMISSION)
    p_prop = b.add_primitive(*proc.make_sphere_mesh(24, 48), bucket=BUCKET_OPAQUE)
    b.add_instance(p_floor, floor_mat)
    b.add_instance(p_wall, wall_mat, translation=(0.0, 3.0, -7.0))
    b.add_instance(p_glass, glass, translation=(0.0, 1.6, -3.5), scale=1.2)
    for x, z, colour in ((-2.4, -4.6, (0.9, 0.2, 0.1, 1.0)), (2.4, -4.8, (0.1, 0.7, 0.2, 1.0))):
        b.add_instance(p_prop, b.add_material(diffuse_factor=colour, roughness_factor=0.5),
                       translation=(x, 0.8, z), scale=0.8)
    return b


class Scene(NamedTuple):
    builder: object
    scene: object
    dl: object
    flags: object
    lights: object
    cfg: RenderConfig | None  # a bench scene's config
    rig: object  # its camera


@functools.lru_cache(maxsize=None)
def _scene(name: str) -> Scene:
    """A scene on the card with its lights and camera: the flagship's and
    the textured-roughness frame's at the flagship's camera, the stress
    scene and the bench's at the bench's first camera."""
    from transmission_renderer_tpu_torch.models.procedural import (
        build_dragon_scene, build_stress_scene)

    if name in cd.BENCH_SCENES:
        scene, dl, flags, cfg, _, lights = cd.bench_scene(name, DEV)
        return Scene(None, scene, dl, flags, lights, cfg, cd.bench_rig(0))
    builder = {"flagship": lambda: build_dragon_scene(roughness_override=0.25),
               "stress": build_stress_scene, "textured": textured_glass_dragon}[name]()
    rig = cd.bench_rig(0) if name == "stress" else cd.flagship_rig()
    return Scene(builder, *builder.finish_bundle(device=DEV), cd.bench_lights(DEV), None, rig)


@functools.lru_cache(maxsize=None)
def _bvh(name: str):
    return _scene(name).builder.build_rt_bvh(device=DEV)


def _render(name: str, rig=None):
    """render(**kw) of frame ``name``, at the scene's camera or ``rig``'s
    -> render_frame's result."""
    from transmission_renderer_tpu_torch.render.frame import render_frame

    f, s = FRAMES[name], _scene(FRAMES[name].scene)
    cfg = f.cfg or s.cfg
    bvh = _bvh(f.scene) if cfg.ray_traced_shadows else None
    params = cd.make_params(cfg, rig or s.rig, DEV)
    return functools.partial(render_frame, s.scene, s.dl, params, s.lights, cfg,
                             flags=s.flags, bvh=bvh)


@functools.lru_cache(maxsize=None)
def _image(name: str) -> tuple:
    """(LDR, HDR) of frame ``name``, rendered once."""
    return _render(name)(return_hdr=True)


class Captured(NamedTuple):
    name: str
    render: object
    img: torch.Tensor
    hdr: torch.Tensor
    diag: object
    calls: dict
    launches: dict
    expected: dict
    orders: tuple


@pytest.fixture(scope="module")
def hd(request):
    """Frame ``request.param`` on the card, every kernel call recorded and
    every launch counted, and the order of each shadow_factors call's rays
    (packet_swizzle; None: the compacted worklist's own)."""
    from transmission_renderer_tpu_torch.render import frame as frame_mod

    name = request.param
    f, s = FRAMES[name], _scene(FRAMES[name].scene)
    render = _render(name)
    real, orders = frame_mod.shadow_factors, []

    def spy(*args, **kwargs):
        orders.append(kwargs.get("packet_swizzle"))
        return real(*args, **kwargs)

    frame_mod.shadow_factors = spy
    try:
        (img, hdr, diag), calls, launches = cd.record(
            lambda: render(return_hdr=True, return_diagnostics=True))
    finally:
        frame_mod.shadow_factors = real
    expected = every_kernel(**(f.launches or cd.expected_launches(s.scene, s.flags)))
    return Captured(name, render, img, hdr, diag, calls, launches, expected, tuple(orders))


CHECKS: dict = {}  # check function -> the frames it holds


def check(*names):
    """Register a check of the frames ``names`` (of every frame without)."""
    def register(fn):
        CHECKS[fn] = names or tuple(FRAMES)
        return fn
    return register


@check()
def launch_counts(hd):
    assert hd.launches == hd.expected


@check()
def image_range(hd):
    """A finite image in [0, 1] of the config's size; no capacity overflow
    (the visibility branch's flagship: its bins overflow, as the
    reference's; the stress frame: only the peel's caps bind)."""
    cfg = hd.render.args[4]
    assert tuple(hd.img.shape) == (cfg.height, cfg.width, 3)
    assert bool(torch.isfinite(hd.img).all())
    assert 0.0 <= float(hd.img.min()) and float(hd.img.max()) <= 1.0
    overflow = FRAMES[hd.name].overflow
    if overflow == "none":
        assert not hd.diag.overflowed(), cd.diagnostics_dict(hd.diag)
    elif overflow == "bins":
        assert hd.diag.overflowed()
    elif overflow == "peel":
        assert not hd.diag._replace(clip_unresolved=0).overflowed()


def matches_plain(hd, kernel):
    """Each of the frame's calls of ``kernel`` through the kernel and its
    plain version (card_defs: check_against_plain, check_occlusion over
    both tables, check_clip_alpha, check_clip_peel)."""
    from transmission_renderer_tpu_torch.ops.cull import transform_vertices

    if kernel == "clip_peel":
        cd.check_clip_peel(hd.calls["clip_worklist"], hd.calls["clip_merge"])
        return
    calls = hd.calls[kernel]
    assert calls
    if kernel == "clip_alpha":
        cd.check_clip_alpha(calls)
    elif kernel == "bvh_occlusion":
        s = _scene(FRAMES[hd.name].scene)
        world = transform_vertices(s.scene, s.dl, hd.render.args[2].proj_view)[0]
        cd.check_occlusion(calls, s.dl.tri_vtx, world)
    else:
        handle = {h.name: h for h in cd.all_handles()}[kernel]
        for call in calls:
            cd.check_against_plain(handle, call)


@check(*[n for n, f in FRAMES.items() if f.golden])
def meets_its_golden(hd):
    """sRGB RMSE < 4e-3 against the reference's 1080p frame, outside the
    tiles where its raster dropped triangles (at most 1% of the frame)."""
    name, dropped = FRAMES[hd.name].golden
    keep = None if dropped is None else cd.golden_keep_mask(hd.render.args[4], dropped)
    assert keep is None or keep.size - keep.sum() <= 0.01 * keep.size
    assert srgb_rmse(hd.img, golden(name), keep) < 4e-3


@check("vis", "stress-vis")
def reference_diagnostics(hd):
    pinned = {"vis": cd.HD_VIS_DIAGNOSTICS, "stress-vis": cd.STRESS_VIS_DIAGNOSTICS}[hd.name]
    assert cd.diagnostics_dict(hd.diag) == pinned


@check("rt", "stress-rt", "vis-rt")
def shadows_only_darken(hd):
    """The HDR image nowhere brighter than the same frame without shadows
    (shadows only remove light) and darker by 0.05 somewhere."""
    base = {"rt": "flagship", "stress-rt": "stress", "vis-rt": "vis"}[hd.name]
    unshadowed = _image(base)[1]
    assert float((hd.hdr - unshadowed).max()) <= 1e-5
    assert bool(((unshadowed - hd.hdr).amax(dim=-1) > 0.05).any())


@check("rt", "rt-half")
def shade_reads_the_shadow_factors(hd):
    """Both shades read shadow factors; at half resolution the opaque one
    reads upsampled (fractional) sun factors."""
    calls = hd.calls["shade"]
    assert all(c[0][0].sun_f is not None and c[0][0].light_f is not None for c in calls)
    if hd.name == "rt-half":
        sun_f = calls[0][0][0].sun_f
        assert bool(((sun_f > 0.0) & (sun_f < 1.0)).any())


@check("rt-half")
def near_full_res(hd):
    """Within RMSE 0.03 of the full-res frame (tests/test_rt_shadows.py's
    bound)."""
    assert float(((hd.img - _image("rt")[0]) ** 2).mean().sqrt()) < 0.03


@check(*[n for n, f in FRAMES.items() if f.orders])
def shadow_ray_orders(hd):
    """Each pass traces its rays in its own order: 8x16 pixel groups
    ("2d"), or the compacted transmission worklist's (None)."""
    assert hd.orders == FRAMES[hd.name].orders


@check("rt")
def ray_order_changes_no_hit(hd):
    """Kernel 5 on the frame's rays put back into row-major pixel order
    hits what it hits in the frame's swizzled order ("2d" opaque, "tiles"
    transmission), ray for ray."""
    from transmission_renderer_tpu_torch.ops import bvh_packet
    from transmission_renderer_tpu_torch.render.raytrace import _packet_swizzle_fns

    n_kinds = 1 + _scene("flagship").lights.num  # the sun and each light
    calls = hd.calls["bvh_occlusion"]
    shapes = [(HD.height, HD.width), (calls[1][0][2].shape[1] // n_kinds,)]
    for call, shape, mode in zip(calls, shapes, ("2d", "tiles")):
        (tree, table, rays, t_min), kw = call
        n = rays.shape[1] // n_kinds
        swz, _ = _packet_swizzle_fns(shape, mode)
        lane_px = swz(torch.arange(n, device=DEV).reshape(shape)).reshape(-1)
        lane = torch.empty_like(lane_px)
        lane[lane_px] = torch.arange(n, device=DEV)
        rays_rm = rays.reshape(10, n_kinds, n)[:, :, lane].reshape(10, -1).contiguous()
        got = bvh_packet.KERNEL.replay(call, True).reshape(n_kinds, -1)[:, lane]
        got_rm = bvh_packet.KERNEL.replay(((tree, table, rays_rm, t_min), kw), True)
        assert torch.equal(got, got_rm.reshape(n_kinds, -1)), mode


@check("rt")
def frontier_traversal_matches_kernel5(hd):
    """ops/bvh.py::trace_shadow_bfs on the opaque pass's shadow rays: the
    hits of kernel 5, ray for ray, without a frontier overflow at the
    first cap_factor from 8 (doubling) that holds it, at most 64."""
    from transmission_renderer_tpu_torch.ops import bvh_packet
    from transmission_renderer_tpu_torch.ops.bvh import trace_shadow_bfs
    from transmission_renderer_tpu_torch.ops.cull import transform_vertices

    call = hd.calls["bvh_occlusion"][0]
    (tree, _, rays, t_min), _ = call
    s = _scene("flagship")
    world = transform_vertices(s.scene, s.dl, hd.render.args[2].proj_view)[0]
    cap_factor = 8
    while True:
        hit, over = trace_shadow_bfs(tree, s.dl.tri_vtx, world, rays[0:3].T, rays[6:9].T,
                                     t_min, rays[9], cap_factor=cap_factor)
        if int(over) == 0:
            break
        cap_factor *= 2
        assert cap_factor <= 64
    assert torch.equal(hit, bvh_packet.KERNEL.replay(call, True))


@check("vis")
def kernel6_order_matches_plain(hd):
    """The frame's kernel-6 calls replayed in kernel-6 order (the frame
    races in the XLA raster's order)."""
    from transmission_renderer_tpu_torch.ops import raster_vis

    for args, kw in hd.calls["raster_vis"]:
        cd.check_against_plain(raster_vis.KERNEL, (args, dict(kw, xla_order=False)))


@check("stress-vis")
def checked_frame_is_silent_and_equal(hd):
    """Both of the frame's kernel-6 calls take the alpha form; its checked
    frame (kernel 6's checked form) prints nothing, equals the frame bit
    for bit and launches as it."""
    from transmission_renderer_tpu_torch.render.checks import checked_frame_fn

    assert all("alpha" in kw for _, kw in hd.calls["raster_vis"])
    s = _scene("stress")
    out = io.StringIO()
    render = checked_frame_fn(config=hd.render.args[4], flags=s.flags, out=out)
    checked, _, launches = cd.record(lambda: render(*hd.render.args[:4]))
    assert out.getvalue() == ""
    assert torch.equal(checked, hd.img) and launches == hd.expected


@check("stress-vis")
def checked_frame_reports_injected_faults(hd):
    """The clip materials' diffuse texture past the atlas through the
    checked frame (kernel 6's error word and the material matrix's
    counter), and a run start past the records through the checked
    kernel: both reported, and the process renders the same frame after."""
    from transmission_renderer_tpu_torch.ops import raster_vis
    from transmission_renderer_tpu_torch.render import checks
    from transmission_renderer_tpu_torch.render.checks import checked_frame_fn

    s = _scene("stress")
    m = s.scene.materials
    n_images = int(s.scene.atlas_meta.shape[0])
    bad_scene = s.scene._replace(materials=m._replace(tex_diffuse=torch.where(
        m.tex_diffuse >= 0, torch.full_like(m.tex_diffuse, n_images), m.tex_diffuse)))
    out = io.StringIO()
    bad = checked_frame_fn(config=hd.render.args[4], flags=s.flags, out=out)(
        bad_scene, *hd.render.args[1:4])
    torch.cuda.synchronize()
    assert any(raster_vis.CHECK_SITES[5] in ln and "out-of-bounds" in ln
               for ln in out.getvalue().splitlines()), out.getvalue()
    assert bool(torch.isfinite(bad).all())
    args, kw = hd.calls["raster_vis"][0]
    run_start = args[2].clone()
    run_start[int(torch.argmax(args[3]))] = args[0][0].shape[0] + 5
    with checks.collect() as found:
        raster_vis.KERNEL.replay((args[:2] + (run_start,) + args[3:], kw), True)
    torch.cuda.synchronize()
    assert (raster_vis.CHECK_SITES[0], None) in found
    assert torch.equal(hd.render(), hd.img)


@check(*FLAG_BOUNDS)
def within_the_references_bound(hd):
    """Each quality flag's frame within the reference's own bound of the
    exact flagship frame, and not equal to it."""
    from transmission_renderer_tpu_torch.scene.textures import linear_to_srgb

    bound, space, _ = FLAG_BOUNDS[hd.name]
    a, b = hd.img.cpu().numpy(), _image("flagship")[0].cpu().numpy()
    if space == "sRGB":
        a, b = linear_to_srgb(a), linear_to_srgb(b)
    assert 0.0 < float(np.sqrt(np.mean((a - b) ** 2))) < bound


@check("textured-roughness")
def reads_the_whole_pyramid(hd):
    """Per-pixel glass roughness: no static level set, so kernel 4's full
    form over every level; the frame within linear RMSE 1e-4 of the same
    frame through the tensor shade."""
    s = _scene("textured")
    assert s.flags.transmission_ior_roughness is None
    (fetch,) = hd.calls["transmission_fetch"]
    assert fetch[0][1] == tuple(range(fetch[0][0].num_levels))
    tensor = hd.render.func(*hd.render.args[:4],
                            dataclasses.replace(hd.render.args[4], pallas_shade=False),
                            flags=s.flags)
    assert float(((hd.img - tensor) ** 2).mean().sqrt()) < 1e-4


@check("dense-rt")
def equals_the_fused_sparse_path(hd):
    """The dense transmission raster and shade (no tile or block cap) with
    shadows: the fused sparse frame's pixels and rays, within 1e-5."""
    assert hd.diag.transmission_tile_capacity == 0 and hd.diag.transmission_block_capacity == 0
    assert float((hd.img - _image("rt")[0]).abs().max()) <= 1e-5


CHECK_FNS = {fn.__name__: fn for fn in CHECKS}
# frame by frame, so that the module's fixture renders each frame once
CASES = [(name, check_name) for name, f in FRAMES.items()
         for check_name in [f"matches_plain-{k}" for k in f.kernels]
         + [fn.__name__ for fn, names in CHECKS.items() if name in names]]


@pytest.mark.parametrize("hd,check_name", CASES, indirect=["hd"],
                         ids=[f"{n}-{c}" for n, c in CASES])
def test_frame(hd, check_name):
    """One check of one frame: matches_plain-<kernel> or a check above."""
    if check_name.startswith("matches_plain-"):
        matches_plain(hd, check_name.split("-", 1)[1])
    else:
        CHECK_FNS[check_name](hd)


def test_raster_gbuf_on_materialised_bins():
    """Kernel 1 over the visibility-buffer flagship's own materialised bins
    (rasterize_gbuffer_pallas on each pass, the transmissive one seeded
    with the opaque depth): every tile walks the non-empty big list before
    its run, as the reference's kernel does, bit for bit against its plain
    version."""
    from transmission_renderer_tpu_torch.config import (
        BUCKET_ALPHA_CLIP, BUCKET_OPAQUE, BUCKET_TRANSMISSION, BUCKET_TRANSMISSION_ALPHA_CLIP)
    from transmission_renderer_tpu_torch.ops import raster_gbuf
    from transmission_renderer_tpu_torch.ops.cull import (
        bucket_triangle_masks, cull_instances, transform_vertices)
    from transmission_renderer_tpu_torch.ops.raster import (
        bin_triangles_materialized, setup_triangles)

    s, cfg = _scene("flagship"), VIS
    params = cd.make_params(cfg, s.rig, DEV)

    def frame():
        world_pos, world_nrm, uvs, clip, tri_scale = transform_vertices(
            s.scene, s.dl, params.proj_view)
        visible = cull_instances(s.scene, params.view, params.frustum_x_xz,
                                 params.frustum_y_yz, cfg.z_near)
        depth = None
        for buckets in ((BUCKET_OPAQUE, BUCKET_ALPHA_CLIP),
                        (BUCKET_TRANSMISSION, BUCKET_TRANSMISSION_ALPHA_CLIP)):
            mask = bucket_triangle_masks(s.dl.tri_inst, s.dl.tri_bucket, visible, buckets)
            setup = setup_triangles(clip, s.dl.tri_vtx, mask, cfg.width, cfg.height,
                                    cfg.tile_w, cfg.tile_h)
            bins = bin_triangles_materialized(setup, cfg.tiles_x, cfg.tiles_y,
                                              cfg.max_tiles_per_tri, cfg.max_tris_per_tile,
                                              cfg.max_big_tris)
            records = raster_gbuf.pack_gbuf_payload(setup, s.dl.tri_vtx, s.dl.tri_material,
                                                    tri_scale, world_pos, world_nrm, uvs)
            g = raster_gbuf.rasterize_gbuffer_pallas(records, bins, cfg.width, cfg.height,
                                                     init_depth=depth)
            depth = g.depth if depth is None else depth

    _, calls, _ = cd.record(frame)
    calls = calls["raster_gbuf"]
    assert len(calls) == 2 and any(int(a[3][0]) > 0 for a, _ in calls)
    for call in calls:
        cd.check_against_plain(raster_gbuf.KERNEL, call)


# ---------------------------------------------------------------------------
# the stress frame's peel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("updates", [0, 11])
def test_stress_clip_caps_across_the_sweep(updates):
    """At the bench's first camera and at its sweep's far end (bench_rig:
    the bench's smoothed rig after target yaw 0.18) the peel's round caps
    are the reference's (STRESS_REFERENCE), the clip tiles' cap
    ceil(2025 * 0.5), and nothing but the peel's caps drops work."""
    _, diag = _render("stress", cd.bench_rig(updates))(return_diagnostics=True)
    got = cd.diagnostics_dict(diag)
    assert got["clip_round_caps"] == cd.STRESS_REFERENCE["clip_round_caps"]
    assert got["clip_tile_capacity"] == 1013
    assert not diag._replace(clip_unresolved=0).overflowed(), got


@pytest.fixture(scope="module")
def stress_converged():
    """The stress frame with its peel run to convergence (8 rounds, every
    failing tile re-raced: the benchmark's peel), recorded."""
    from transmission_renderer_tpu_torch.render.frame import render_frame

    s = _scene("stress")
    cfg = dataclasses.replace(STRESS, alpha_clip_rounds=8, clip_retile_cap_frac=1.0)
    params = cd.make_params(cfg, s.rig, DEV)
    return cd.record(lambda: render_frame(s.scene, s.dl, params, s.lights, cfg, flags=s.flags,
                                          return_diagnostics=True))


def test_stress_converged_meets_its_golden(stress_converged):
    """No pixel unresolved, nothing overflowed, and tests/goldens/
    stress_hd.png (the reference's frame) within sRGB RMSE 4e-3."""
    (img, diag), _, launches = stress_converged
    assert int(diag.clip_unresolved) == 0 and not diag.overflowed()
    assert launches["clip_alpha"] == 16
    assert srgb_rmse(img, golden("stress_hd")) < 4e-3


def test_stress_converged_peel_kernels_match_plain(stress_converged):
    """Its 16 alpha tests, and its 14 re-race rounds' worklists and merges
    (csrc/clip_peel.cu), bit for bit against their plain versions."""
    _, calls, _ = stress_converged
    assert len(calls["clip_alpha"]) == 16 and len(calls["clip_worklist"]) == 14
    cd.check_clip_alpha(calls["clip_alpha"])
    cd.check_clip_peel(calls["clip_worklist"], calls["clip_merge"])


# ---------------------------------------------------------------------------
# the bench's other scenes; the frame variants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(cd.BENCH_SCENES))
def test_bench_scene_holds_at_the_sweep_end(name):
    """No capacity overflow at the bench sweep's far end (its first camera:
    test_frame_image)."""
    _, diag = _render(name, cd.bench_rig(11))(return_diagnostics=True)
    assert not diag.overflowed(), cd.diagnostics_dict(diag)


@pytest.mark.parametrize("name", [n for n, s in cd.BENCH_SCENES.items() if s["small"]])
def test_bench_scene_small_golden(name):
    """The scene's small golden at 128x72 (8x128 tiles) on the card: no
    overflow, sRGB RMSE < 4e-3."""
    from transmission_renderer_tpu_torch.render.frame import render_frame

    scene, dl, flags, cfg, params, lights = cd.bench_scene(name, DEV, small=True)
    img, diag = render_frame(scene, dl, params, lights, cfg, flags=flags,
                             return_diagnostics=True)
    assert not diag.overflowed()
    assert srgb_rmse(img, golden(name)) < 4e-3


@pytest.mark.parametrize("frac", [0.5, 0.01])
def test_compacted_flagship_frame(frac):
    """The flagship with pallas_pair_cap_frac: at 0.5 the stream fits,
    the frame reports its binning's demand and capacity, launches the
    flagship's kernels and equals its frame bit for bit; at 0.01 (the
    65,536-slot floor) the overflow is reported and the image stays
    finite in [0, 1]."""
    render = _render("flagship")
    (args,) = cd.binning_calls(render)
    demand, cap, _ = cd.check_compacted_bins(args, frac)
    cfg = dataclasses.replace(HD, pallas_pair_cap_frac=frac)
    (img, diag), _, launches = cd.record(lambda: render.func(
        *render.args[:4], cfg, flags=render.keywords["flags"], return_diagnostics=True))
    assert (int(diag.pair_demand), diag.pair_capacity) == (demand, cap)
    if frac == 0.5:
        assert launches == every_kernel(**FLAGSHIP) and not diag.overflowed()
        assert torch.equal(img, _image("flagship")[0])
    else:
        assert diag.overflowed() and demand > cap
        assert bool(torch.isfinite(img).all()) and 0.0 <= float(img.min())
        assert float(img.max()) <= 1.0


# ---------------------------------------------------------------------------
# the CLI (cli.main in process, at its defaults: 1920x1080, the flagship's
# camera, sun and lights)
# ---------------------------------------------------------------------------

def cli_run(argv: list) -> tuple:
    """(linear frames, {kernel: recorded calls}, {kernel: launches},
    stderr) of one run of the port's CLI, which must exit 0."""
    from transmission_renderer_tpu_torch import cli

    frames_out, err = [], io.StringIO()
    with contextlib.redirect_stderr(err):
        rc, calls, launches = cd.record(lambda: cli.main(argv, frames_out=frames_out),
                                        snapshots=False)
    assert rc == 0, err.getvalue()
    return frames_out, calls, launches, err.getvalue()


DRAGON = ["--procedural", "dragon", "--roughness-override", "0.25"]


def test_cli_flagship(tmp_path):
    """The flagship through the CLI: render_frame's frame exactly, and
    its PNG within sRGB RMSE 4e-3 of dragon_hd.png outside the golden's
    dropped tiles."""
    from transmission_renderer_tpu_torch.utils.png import read_png

    frames_out, _, launches, _ = cli_run(DRAGON + ["-o", str(tmp_path / "dragon.png")])
    assert np.array_equal(frames_out[0], _image("flagship")[0].cpu().numpy())
    assert launches == every_kernel(**FLAGSHIP)
    png = read_png(str(tmp_path / "dragon.png"))[..., :3] / 255.0
    keep = cd.golden_keep_mask(HD)
    assert float(np.sqrt(np.mean((png[keep] - golden("dragon_hd")[keep]) ** 2))) < 4e-3


@pytest.mark.parametrize("scene", ["dragon", "stress"])
def test_cli_as_debug_matches_the_plain_walk(scene, tmp_path):
    """--as-debug: the closest-hit kernel launches once and nothing else
    does; on every camera ray its hit and triangle id equal its plain
    walk's and t, u, v are bit-equal; on the stress scene some ray's
    closest candidate is rejected by its alpha test (the kernel replayed
    with every cutoff at -inf hits another triangle)."""
    from transmission_renderer_tpu_torch.ops import bvh, bvh_closest

    frames_out, calls, launches, _ = cli_run(["--procedural", scene, "--as-debug", "-o",
                                              str(tmp_path / "as_debug.png")])
    assert launches == every_kernel(bvh_closest=1)
    assert np.isfinite(frames_out[0]).all()
    (call,) = calls["bvh_closest"]
    (tree, table, rays, t_min, alpha), kw = call
    got = bvh_closest.KERNEL.replay(call, True)
    hit, t, tri, u, v = bvh.closest_walk(tree, table, rays, t_min, alpha.test)[:5]
    assert torch.equal(got[0], hit) and torch.equal(got[2], tri)
    for g, r in zip((got[1], got[3], got[4]), (t, u, v)):
        assert float((g - r).abs().max()) == 0.0
    if scene == "stress":
        no_clip = alpha._replace(cutoff=torch.full_like(alpha.cutoff, -torch.inf))
        geo = bvh_closest.KERNEL.replay(((tree, table, rays, t_min, no_clip), kw), True)
        assert bool((geo[0] & (geo[2] != got[2])).any())


def test_cli_debug_clusters(tmp_path):
    """--debug-clusters: the reference's gate sends both shade passes to
    the tensor shade, so kernel 1 launches twice and kernels 2-4 never."""
    frames_out, _, launches, _ = cli_run(["--procedural", "dragon", "--debug-clusters",
                                          "--cluster-wireframe", "5", "-o",
                                          str(tmp_path / "clusters.png")])
    assert launches == every_kernel(raster_gbuf=2)
    img = frames_out[0]
    assert np.isfinite(img).all() and img.min() >= 0.0 and img.max() <= 1.0


@functools.lru_cache(maxsize=None)
def _cli_glb(name: str) -> tuple:
    """cli_run of a GLB fixture with --check-nan at the CLI's defaults."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        return cli_run([os.path.join(ROOT, "tests", "assets", name), "--external-model",
                        "--no-sponza", "--check-nan", "-o", os.path.join(tmp, "glb.png")])


@pytest.mark.parametrize("name", ["multi.glb", "jpeg.glb"])
def test_cli_glb_check_nan(name):
    """multi.glb (binary-chunk PNGs) and jpeg.glb (its scene with JPEGs),
    decoded without PIL: no non-finite pixel; one VALIDATION line, the
    sparse transmissive raster's tile overflow at the reference's own
    count (MULTI_GLB_TRANSMISSION_TILES against the default cap of 507),
    and no other overflow; kernel 1 bit for bit against its plain version
    on the frame's calls; jpeg.glb launches as multi.glb."""
    from transmission_renderer_tpu_torch.ops import raster_gbuf
    from transmission_renderer_tpu_torch.render.frame import FrameDiagnostics

    frames_out, calls, launches, err = _cli_glb(name)
    assert np.isfinite(frames_out[0]).all() and "non-finite" not in err
    lines = [ln for ln in err.splitlines() if "VALIDATION" in ln]
    assert len(lines) == 1 and "capacity overflow" in lines[0], lines
    assert f"transmission_tiles=tensor({cd.MULTI_GLB_TRANSMISSION_TILES}" in lines[0]
    assert "transmission_tile_capacity=507" in lines[0]
    fields = dict(re.findall(r"(\w+)=(?:tensor\()?(\d+)", lines[0]))
    diag = FrameDiagnostics(**{f: int(fields[f]) for f in FrameDiagnostics._fields
                               if f in fields and not f.startswith("clip_round")})
    assert not diag._replace(transmission_tiles=0).overflowed(), lines[0]
    for call in calls["raster_gbuf"]:
        cd.check_against_plain(raster_gbuf.KERNEL, call)
    assert launches == _cli_glb("multi.glb")[2]


def test_jpeg_fixture_decodes_to_its_digests():
    """decode_jpeg (stdlib and NumPy) gives each image of jpeg.glb PIL's
    RGBA, by the SHA-256 and shape in tests/assets/jpeg_digests.json."""
    from transmission_renderer_tpu_torch.utils.jpeg import decode_jpeg

    with open(os.path.join(ROOT, "tests", "assets", "jpeg.glb"), "rb") as f:
        images = cd.glb_images(f.read())
    with open(os.path.join(ROOT, "tests", "assets", "jpeg_digests.json")) as f:
        digests = json.load(f)
    for k, (data, want) in enumerate(zip(images, digests)):
        rgba = decode_jpeg(data, f"image {k}")
        assert list(rgba.shape) == want["shape"]
        assert hashlib.sha256(rgba.tobytes()).hexdigest() == want["sha256"]


def test_cli_jpeg_glb_equals_its_png_twin(tmp_path):
    """jpeg.glb's frame equals, bit for bit and launch for launch, the
    frame of its twin whose images are PNGs of the decoded RGBA (written
    by the port's PNG writer)."""
    from transmission_renderer_tpu_torch.utils.jpeg import decode_jpeg
    from transmission_renderer_tpu_torch.utils.png import write_png

    with open(os.path.join(ROOT, "tests", "assets", "jpeg.glb"), "rb") as f:
        glb = f.read()
    pngs = []
    for k, data in enumerate(cd.glb_images(glb)):
        write_png(str(tmp_path / f"{k}.png"), decode_jpeg(data)[..., :3])  # opaque
        pngs.append(((tmp_path / f"{k}.png").read_bytes(), "image/png"))
    (tmp_path / "twin.glb").write_bytes(cd.glb_with_images(glb, pngs))
    frames_out, _, launches, _ = cli_run([str(tmp_path / "twin.glb"), "--external-model",
                                          "--no-sponza", "-o", str(tmp_path / "twin.png")])
    jpeg_frames, _, jpeg_launches, _ = _cli_glb("jpeg.glb")
    assert np.array_equal(frames_out[0], jpeg_frames[0]) and launches == jpeg_launches


def test_cli_spotlights_and_rotating_model(tmp_path):
    """--spotlights --rotate-model --frames 3: three finite PNGs, frames
    1 and 2 differing from frame 0."""
    frames_out, _, _, _ = cli_run(["--procedural", "dragon", "--spotlights", "--rotate-model",
                                   "--frames", "3", "-o", str(tmp_path / "spots.png")])
    assert sorted(p.name for p in tmp_path.glob("spots_*")) == [
        "spots_000.png", "spots_001.png", "spots_002.png"]
    assert len(frames_out) == 3 and all(np.isfinite(f).all() for f in frames_out)
    assert min(float(np.abs(frames_out[k] - frames_out[0]).max()) for k in (1, 2)) > 0.0


def test_cli_debug_checks(tmp_path):
    """--debug-checks on the flagship: the visibility-buffer branch through
    kernel 6's checked form, which reports nothing and launches twice;
    the frame equals render_frame's visibility-buffer frame."""
    frames_out, _, launches, err = cli_run(DRAGON + ["--debug-checks", "-o",
                                                     str(tmp_path / "checked.png")])
    assert "out-of-bounds" not in err and "CHECKS" not in err, err
    assert launches == every_kernel(raster_vis=2)
    assert np.array_equal(frames_out[0], _image("vis")[0].cpu().numpy())


@pytest.mark.parametrize("flag", list(FLAG_BOUNDS))
def test_cli_quality_flag(flag, tmp_path):
    """Each quality flag through the CLI: render_frame's frame exactly."""
    frames_out, _, launches, _ = cli_run(DRAGON + [FLAG_BOUNDS[flag][2], "-o",
                                                   str(tmp_path / "f.png")])
    assert np.array_equal(frames_out[0], _image(flag)[0].cpu().numpy())
    assert launches == every_kernel(**FRAMES[flag].launches)


# ---------------------------------------------------------------------------
# the row-band frames (parallel/sharded.py)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _glass() -> np.ndarray:
    """[1080, 1920] bool: the pixels the flagship's transmissive raster
    wins, from its dense form's kernel-1 call over every tile."""
    from transmission_renderer_tpu_torch.ops import raster_gbuf
    from transmission_renderer_tpu_torch.ops.raster import untile_image

    render = _render("flagship")
    dense = dataclasses.replace(HD, transmission_tile_cap_frac=None)
    _, calls, _ = cd.record(lambda: render.func(*render.args[:4], dense,
                                                flags=render.keywords["flags"]))
    (call,) = [c for c in calls["raster_gbuf"] if c[1].get("pass_class") == 1]
    tri = raster_gbuf.KERNEL.replay(call, True)["tri"]
    return (untile_image(tri, 15, 135, 128, 8, 1920, 1080) >= 0).cpu().numpy()


def _off_glass(a, b) -> float:
    return float(np.abs(a - b).max(axis=-1)[~_glass()].max())


@pytest.fixture(scope="module")
def one_rank():
    """The row-band frames of a one-rank NCCL group: band_frames(mesh)."""
    import torch.distributed as dist
    from transmission_renderer_tpu_torch.parallel import make_band_mesh
    from transmission_renderer_tpu_torch.parallel.ranks import free_init_method

    dist.init_process_group("nccl", init_method=free_init_method(), world_size=1, rank=0)
    try:
        return cd.band_frames(make_band_mesh(1))
    finally:
        dist.destroy_process_group()


def test_band_group_of_one_rank(one_rank):
    """One band over NCCL: kernels 1-3 on the band's tiles (their calls
    against their plain versions in band_frames), kernel 4 replaced by the
    band pyramid's sampler; the frame and the ray-traced frame within
    2e-6 of render_frame's, no overflow, the diagnostics the two share
    equal (the tier ladder's, the peel's)."""
    from transmission_renderer_tpu_torch.render.frame import FrameDiagnostics

    assert one_rank["launches"] == every_kernel(raster_gbuf=2, tap_finish=1, shade=2)
    assert not FrameDiagnostics(**one_rank["diag"]).overflowed()
    for key, name in (("default", "flagship"), ("rt", "rt")):
        assert float(np.abs(one_rank[key] - _image(name)[0].cpu().numpy()).max()) \
            <= SHARDED_MAX_ABS, key
    _, diag = _render("flagship")(return_diagnostics=True)
    single = cd.diagnostics_dict(diag)
    for f in ("max_bin_count", "big_tri_count", "big_tri_capacity", "mid_tri_count",
              "mid_tri_capacity", "tier_overflow", "clip_unresolved"):
        assert one_rank["diag"][f] == single[f], f


@pytest.mark.parametrize("n", [2, 4])
def test_band_group_sharing_the_card(n, one_rank, monkeypatch):
    """n ranks, each a process, sharing card 0 over gloo (staged through
    the host): the launches and diagnostics of one rank; at a halo of the
    band height the frame within 2e-6 of one rank's everywhere, at the
    default halo and with shadows off the glass; kernel 5 exact on every
    band, and the last band's kernels 1-3 (its tiles run into the rows
    padded below the frame) against their plain versions. On 2 ranks the
    converged stress frame within sRGB RMSE 4e-3 of stress_hd.png, its
    peel's kernels bit for bit on every rank's tile ids, and the
    visibility-branch stress frame within 2e-6 of render_frame's."""
    from transmission_renderer_tpu_torch.parallel import ranks
    from transmission_renderer_tpu_torch.render.frame import render_frame

    monkeypatch.setattr(ranks, "band_backend", lambda n, device: "gloo")
    with ranks.BandRanks(n, cd.band_rank, (n == 2,), device="cuda") as mesh:
        assert mesh.staged
        out = cd.band_frames(mesh, n == 2)
    assert out["launches"] == one_rank["launches"] and out["diag"] == one_rank["diag"]
    assert out["rt_launches"]["bvh_occlusion"] == 2
    assert float(np.abs(out["full_halo"] - one_rank["default"]).max()) <= SHARDED_MAX_ABS
    for key in ("default", "rt"):
        assert _off_glass(out[key], one_rank[key]) <= SHARDED_MAX_ABS, key
    if n == 2:
        assert srgb_rmse(out["stress"], golden("stress_hd")) < 4e-3
        cfg = cd.sharded_configs(2)["stress_vis"]
        s = _scene("stress")
        ref, diag = render_frame(s.scene, s.dl, cd.make_params(cfg, s.rig, DEV), s.lights, cfg,
                                 flags=s.flags, return_diagnostics=True)
        assert float(np.abs(out["stress_vis"] - ref.cpu().numpy()).max()) <= SHARDED_MAX_ABS
        assert out["stress_vis_launches"]["raster_vis"] == 2
        vd, single = out["stress_vis_diag"], cd.diagnostics_dict(diag)
        assert vd["max_bin_count"] <= vd["bin_capacity"]
        assert vd["big_tri_count"] <= vd["big_tri_capacity"]
        for f in ("max_bin_count", "big_tri_count", "clip_unresolved"):
            assert vd[f] == single[f], f


@pytest.mark.parametrize("n", [2, 4])
def test_band_group_on_cards(n, tmp_path):
    """n ranks with a card each over NCCL: the frame off the glass and at
    a halo of the band height everywhere, and the ray-traced frame at full
    and half resolution off the glass, within 2e-6 of render_frame's; then
    cli.main --devices n off the glass."""
    from transmission_renderer_tpu_torch.parallel.ranks import BandRanks

    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} cards")
    with BandRanks(n, cd.band_rank, (False,), device="cuda") as mesh:
        assert not mesh.staged
        out = cd.band_frames(mesh)
    flagship = _image("flagship")[0].cpu().numpy()
    assert float(np.abs(out["full_halo"] - flagship).max()) <= SHARDED_MAX_ABS
    for key, name in (("default", "flagship"), ("rt", "rt"), ("rt_half", "rt-half")):
        assert _off_glass(out[key], _image(name)[0].cpu().numpy()) <= SHARDED_MAX_ABS, key
    frames_out, _, _, _ = cli_run(DRAGON + ["--devices", str(n), "-o",
                                            str(tmp_path / "bands.png")])
    assert _off_glass(frames_out[0], flagship) <= SHARDED_MAX_ABS


def test_cli_devices_refused_on_one_card(tmp_path):
    """--devices 2 on a one-card host exits 2 with the reference's
    message."""
    from transmission_renderer_tpu_torch import cli

    if torch.cuda.device_count() > 1:
        pytest.skip("a host with one card")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["--procedural", "dragon", "--devices", "2", "-o",
                       str(tmp_path / "never.png")])
    assert rc == 2 and err.getvalue().strip() == "error: --devices 2 but only 1 available"
