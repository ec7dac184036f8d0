"""Fused deferred shade (kernel 3): the opaque fragment shader, and the
transmission fragment shader up to its framebuffer/LUT fetches.

Counterpart of ``transmission_renderer_tpu/render/shade_kernel.py``
(shade_opaque_pallas_planes, shade_transmission_pallas_pre,
pallas_shade_supported, N_TRANS_OUT). ``fused_shade`` launches
``csrc/shade.cu`` for CUDA tensors and runs ``fused_shade_plain`` for CPU
tensors; both compute, per pixel and in the reference kernel's op order:
material row and texture factors, the cotangent-frame normal map, the
cluster z-slice, the sun and the clustered light loop through
``basic_brdf`` (and ``transmission_btdf`` in transmission mode), the
emission, and for transmission the refraction ray, its exit point's
screen uv and the framebuffer lod.

Where the TPU kernel selected each block's cluster candidates through a
where-chain, the port reads the per-cluster light list (counts, ids from
pbr/clustering.py) directly, as the reference's fragment shader does. The
list is id-ascending, so lights add in the oracle's order; inactive
slots add exact zeros in the oracle and are skipped here.

Cluster x/y divide by the cluster size the way the reference's jitted
frame does: as a multiply by the float32 reciprocal of the constant.

With ray-traced shadows the kernel also reads the shadow factors: a sun
plane and one plane per light, indexed by light id (the reference's
shade_kernel.py:486-493 and :550-551). The opaque variant floors the sun
factor at 0.1 (the ambient floor, lighting.rs:166); the transmission
variant applies it raw. Without factors the kernel is unchanged.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from transmission_renderer_tpu_torch import kernels
from transmission_renderer_tpu_torch.pbr.brdf import F32_EPSILON, _FRAC_1_PI
from transmission_renderer_tpu_torch.pbr.clustering import (
    ClusterCoefficients,
    get_depth_slice,
)

# transmission outputs: d(3) s(3) t(3) uv(2) lod raylen nov rough tf
# att_dist att_colour(3) diffuse(3) f0(3) f90(3) emission(3)
N_TRANS_OUT = 32
TRANS_NAMES = (
    "d_r", "d_g", "d_b", "s_r", "s_g", "s_b", "t_r", "t_g", "t_b",
    "uv_x", "uv_y", "lod", "ray_len", "nov", "rough", "tf",
    "att_dist", "att_r", "att_g", "att_b",
    "dc_r", "dc_g", "dc_b", "f0_r", "f0_g", "f0_b",
    "f90_r", "f90_g", "f90_b", "em_r", "em_g", "em_b",
)

# material-matrix columns (render/shading.py::build_material_matrix)
_C_METALLIC, _C_ROUGHNESS, _C_DIFFUSE, _C_EMISSIVE = 0, 1, 2, 6
_C_IOR, _C_TRANSMISSION, _C_THICKNESS, _C_ATT_DIST = 9, 10, 11, 12
_C_ATT_COLOUR, _C_SPEC_FACTOR, _C_SPEC_COLOUR, _C_ATT_ISINF = 13, 16, 17, 20
_C_TID0 = 21
MAT_COLS = 29
# _MAT_SLOTS index per tex_slots flag position
_SLOT_TO_IMAT = {0: 0, 1: 1, 2: 2, 3: 3, 5: 4, 6: 5, 7: 6, 8: 7}

# per-pixel input planes, in order (the derivative planes only with a
# normal-map slot)
PIX_BASE = ("pos_x", "pos_y", "pos_z", "nrm_x", "nrm_y", "nrm_z", "depth",
            "valid", "mscale")
PIX_DERIV = ("dpx_x", "dpx_y", "dpx_z", "dpy_x", "dpy_y", "dpy_z",
             "duvx_u", "duvx_v", "duvy_u", "duvy_v")

_PI_F32 = float(np.float32(np.pi))
_FRAC_1_PI_F32 = float(np.float32(_FRAC_1_PI))


def _f32(x) -> float:
    """A Python float holding x rounded to float32."""
    return float(np.float32(x))


class ShadeSpec(NamedTuple):
    """Static kernel configuration."""

    n_layers: int  # bundle layers per sample bundle (0 = no samples)
    tex_slots: tuple  # the 9 SceneFlags slot flags
    slot_bundle: tuple  # bundle index per _MAT_SLOTS entry
    ncx: int
    ncy: int
    n_slices: int
    rcp_csx: float  # float32 1 / cluster width in pixels
    rcp_csy: float
    coeff_scale: float
    coeff_bias: float
    z_near: float
    z_far: float
    transmission: bool
    fb_width: float


class ShadeInputs(NamedTuple):
    scalars: torch.Tensor  # [32] view pos, sun dir, sun intensity, pad, proj_view
    mat: torch.Tensor  # [n_mat, 29] material matrix head
    lmat: torch.Tensor  # [L, 12] light matrix
    counts: torch.Tensor  # [C] int32 per-cluster light count
    indices: torch.Tensor  # [C, S] int32 per-cluster ascending light ids
    block_py: torch.Tensor  # [M / 128] int32 framebuffer row of each block
    block_px0: torch.Tensor  # [M / 128] int32 first pixel x of each block
    pix: torch.Tensor  # [len(PIX_BASE) (+ len(PIX_DERIV)), M] float32
    mid: torch.Tensor  # [M] int32 material id
    samples: torch.Tensor  # [n_bundles * 4 * n_layers, M] float32
    sun_f: torch.Tensor | None = None  # [M] sun shadow factor
    light_f: torch.Tensor | None = None  # [L, M] per-light shadow factors


# ---------------------------------------------------------------------------
# vec3 helpers on (x, y, z) tuples of planes
# ---------------------------------------------------------------------------

def _add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def _mul(a, b):
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def _dot_raw(a, b):
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def _dot(a, b):
    return torch.clamp(_dot_raw(a, b), min=F32_EPSILON)


def _norm(v):
    inv = 1.0 / torch.sqrt(_dot_raw(v, v))
    return (v[0] * inv, v[1] * inv, v[2] * inv)


def _pow5(x):
    x2 = x * x
    return x2 * x2 * x


def _d_ggx(noh, ar):
    a2 = ar * ar
    f = (noh * noh) * (a2 - 1.0) + 1.0
    return torch.where(f * f > 0.0, a2 / (_PI_F32 * f * f), 0.0)


def _v_smith(nov, nol, ar):
    a2 = ar * ar
    ggx_v = nol * torch.sqrt(nov * nov * (1.0 - a2) + a2)
    ggx_l = nov * torch.sqrt(nol * nol * (1.0 - a2) + a2)
    ggx = ggx_v + ggx_l
    return torch.where(ggx > 0.0, 0.5 / ggx, 0.0)


def _fresnel(voh, f0, f90):
    t = _pow5(1.0 - voh)
    return tuple(f0[i] + (f90[i] - f0[i]) * t for i in range(3))


def _basic_brdf(normal, light, intensity, view, m):
    """pbr/brdf.py::basic_brdf -> (diffuse, specular)."""
    halfway = _norm(_add(view, light))
    noh = _dot(normal, halfway)
    nov = _dot(normal, view)
    nol = _dot(normal, light)
    voh = _dot(view, halfway)
    fresnel = _fresnel(voh, m["f0"], m["f90"])
    radiance = _scale(intensity, nol)
    fmax = torch.maximum(torch.maximum(fresnel[0], fresnel[1]), fresnel[2])
    dweight = (1.0 - fmax) * _FRAC_1_PI_F32
    diffuse = _mul(radiance, _scale(m["c_diff"], dweight))
    dv = _d_ggx(noh, m["ar"]) * _v_smith(nov, nol, m["ar"])
    specular = _mul(_scale(radiance, dv), fresnel)
    return diffuse, specular


def _transmission_btdf(normal, light, view, m, trans_rough):
    """pbr/brdf.py::transmission_btdf (glam-pbr lib.rs:200-233)."""
    l_dot_n = _dot_raw((-light[0], -light[1], -light[2]), normal)
    lm = _norm(_add(light, _scale(normal, 2.0 * l_dot_n)))
    halfway = _norm(_add(view, lm))
    noh = _dot(normal, halfway)
    voh = _dot(view, halfway)
    nov = _dot(normal, view)
    nol_m = _dot(normal, lm)
    dv = _d_ggx(noh, trans_rough) * _v_smith(nov, nol_m, trans_rough)
    fres = _fresnel(voh, m["f0"], m["f90"])
    return tuple((1.0 - fres[i]) * dv * m["diffuse"][i] for i in range(3))


def pixel_clusters(spec: ShadeSpec, depth: torch.Tensor, px: torch.Tensor,
                   py: torch.Tensor) -> torch.Tensor:
    """Cluster id (int32) of each pixel (shader/src/lib.rs:205-215) from
    its depth and float32 pixel coordinates, as the kernel computes it."""
    coeffs = ClusterCoefficients(spec.z_near, spec.z_far, spec.coeff_scale,
                                 spec.coeff_bias, spec.n_slices)
    zsl = torch.clamp(get_depth_slice(coeffs, depth), max=spec.n_slices - 1)
    cx = torch.clamp(((px + 0.5) * spec.rcp_csx).to(torch.int32), max=spec.ncx - 1)
    cy = torch.clamp(((py + 0.5) * spec.rcp_csy).to(torch.int32), max=spec.ncy - 1)
    return zsl * (spec.ncx * spec.ncy) + cy * spec.ncx + cx


class ShadeWork(NamedTuple):
    """What one kernel-3 call must do on its data (``shade_work``)."""

    nbytes: int  # bytes read (each needed input once) and written
    ops: int  # float operations of the kernel's arithmetic
    valid: int  # pixels shaded (the rest only write zeros)
    lights: int  # (valid pixel, light) pairs evaluated
    warps: int  # 32-pixel warps holding a valid pixel
    uniform_warps: int  # ... whose valid pixels share one cluster


# Operations of csrc/shade.cu, counted from its arithmetic (add, sub, mul,
# div, sqrt, min, max, compare, log2 and cos one each; integer address
# arithmetic not counted). Helpers: a dot product 5, clamped 6, normalise
# 10, fresnel 13, d_ggx 11, v_smith 16. basic_brdf: 97 (view + light 3,
# normalise 10, four clamped dots 24, fresnel 13, radiance 3, diffuse
# weight 4, diffuse 6, d * v 28, specular 6), 6 more to accumulate;
# transmission_btdf 109 (the mirrored light 22, the half vector 13, four
# clamped dots 24, d * v 28, fresnel 13, (1 - F) d v diffuse 9).
_OPS_SETUP = 2 + 11 + 25 + 14 + 19  # material clamp, normal, invariants, view, cluster
_OPS_OPAQUE = _OPS_SETUP + 97 + 6  # + the sun's BRDF, diffuse + specular + emission
# + the transmission set-up (trans roughness 5, ray length 1, lod 6,
# attenuation distance 1), the sun's BRDF and BTDF (97 + 109 + 3) and the
# refraction ray (68: eta, n.i, k, its coefficient, the ray, 1/|ray|, the
# exit point, three clip rows, uv)
_OPS_TRANS = _OPS_SETUP + 13 + 97 + 112 + 68
# a light: its vector, distance, direction, attenuation, weight and
# radiance 18, then the BRDF 103; the opaque variant tests is_spot (1)
# and a spot light adds 11 (its epsilon, theta, cos, the falloff); the
# transmission variant adds the BTDF and its accumulation (115)
_OPS_LIGHT_OPAQUE = 18 + 1 + 103
_OPS_SPOT = 11
_OPS_LIGHT_TRANS = 18 + 103 + 115
# a texture slot in use: its layer (max, compare) and the tid test (3),
# then where the tid is valid the factor's multiplies (the normal map:
# the tangent frame and the renormalised normal, 84)
_OPS_SLOT = 3
_SLOT_MULS = {0: 3, 1: 2, 2: 84, 3: 3, 5: 1, 6: 1, 7: 1, 8: 3}  # by tex_slots position


def shade_work(inp: ShadeInputs, spec: ShadeSpec) -> ShadeWork:
    """The bytes and operations one kernel-3 call needs on its own data:
    an invalid pixel reads its valid flag and writes zeros; a valid one
    reads the planes the kernel reads (position, normal, depth, the
    thickness scale in transmission mode, the derivative planes with a
    normal map, the material id, the 4 sample channels of each texture
    slot in use, the shadow factors of the sun and of each light it
    evaluates) and does the set-up, the texture factors its material's
    slots hold, and the BRDF (and BTDF) of the sun and of each light of
    its cluster's list. The tables count once."""
    T = spec.transmission
    dev = inp.mid.device
    m_pix = inp.mid.shape[0]
    valid = inp.pix[7] > 0.5
    n_valid = int(valid.sum())
    blk = torch.arange(m_pix, device=dev) // 128
    lane = (torch.arange(m_pix, device=dev) % 128).to(torch.float32)
    cluster = pixel_clusters(spec, inp.pix[6], inp.block_px0[blk].to(torch.float32) + lane,
                             inp.block_py[blk].to(torch.float32)).long()
    n_slots = inp.indices.shape[1]
    count = torch.where(valid, torch.clamp(inp.counts[cluster], max=n_slots), 0)
    lights = int(count.sum())
    ops = n_valid * (_OPS_TRANS if T else _OPS_OPAQUE)
    ops += lights * (_OPS_LIGHT_TRANS if T else _OPS_LIGHT_OPAQUE)
    if inp.light_f is not None:
        ops += lights
    if inp.sun_f is not None:
        ops += n_valid * (3 if T else 4)
    if not T and n_slots:
        slot = torch.arange(n_slots, device=dev)
        lid = inp.indices[cluster].long()  # [M, S]
        spots = (slot[None] < count[:, None]) & (inp.lmat[lid, 11] > 0.5)
        ops += int(spots.sum()) * _OPS_SPOT
    mid = torch.clamp(inp.mid, 0, inp.mat.shape[0] - 1).long()[valid]
    slots = [f for f, on in enumerate(spec.tex_slots)
             if on and f in _SLOT_MULS and (T or f not in (5, 6))]
    for f in slots:
        hit = int((inp.mat[mid, _C_TID0 + _SLOT_TO_IMAT[f]].to(torch.int32) >= 0).sum())
        ops += n_valid * _OPS_SLOT + hit * _SLOT_MULS[f]
    planes = 7 + T + (len(PIX_DERIV) if spec.tex_slots[2] else 0)
    per_valid = 4 * (planes + 1 + 4 * len(slots) + (inp.sun_f is not None))
    tables = sum(t.nbytes for t in (inp.scalars, inp.mat, inp.lmat, inp.counts, inp.indices,
                                    inp.block_py, inp.block_px0))
    nbytes = (tables + m_pix * 4 * (1 + (N_TRANS_OUT if T else 3)) + n_valid * per_valid
              + lights * 4 * (inp.light_f is not None))
    # the kernel's warp test: the valid lanes of a warp share one cluster
    vw = valid.reshape(-1, 32)
    cw = cluster.reshape(-1, 32)
    lo = torch.where(vw, cw, torch.iinfo(torch.int64).max).amin(dim=1)
    hi = torch.where(vw, cw, -1).amax(dim=1)
    busy = vw.any(dim=1)
    return ShadeWork(nbytes, ops, n_valid, lights, int(busy.sum()),
                     int((busy & (lo == hi)).sum()))


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def fused_shade_plain(inp: ShadeInputs, spec: ShadeSpec) -> list:
    """Per-pixel fused shade in plain PyTorch -> 3 (opaque) or 32
    (transmission) [M] planes; invalid pixels write 0."""
    (use_diffuse, use_mr, use_normal, use_emissive, _occ, use_tr, use_th,
     use_spec, use_spec_col) = spec.tex_slots
    T = spec.transmission
    dev = inp.mid.device
    m_pix = inp.mid.shape[0]
    P = dict(zip(PIX_BASE + (PIX_DERIV if use_normal else ()), inp.pix))
    pos = (P["pos_x"], P["pos_y"], P["pos_z"])
    nrm = (P["nrm_x"], P["nrm_y"], P["nrm_z"])
    depth = P["depth"]
    valid = P["valid"] > 0.5
    mrow = inp.mat[torch.clamp(inp.mid, 0, inp.mat.shape[0] - 1).long()]  # [M, 29]
    mv = {c: mrow[:, c] for c in range(MAT_COLS)}

    def slot_sample(flag_pos):
        imat = _SLOT_TO_IMAT[flag_pos]
        tid = mv[_C_TID0 + imat].to(torch.int32)
        layer = torch.clamp(tid, min=0) >> 16
        layer = torch.where(layer < spec.n_layers, layer, 0).long()
        base = spec.slot_bundle[imat] * 4 * spec.n_layers
        samples = inp.samples
        ch = []
        for c in range(4):
            rows = base + 4 * layer + c  # [M]
            ch.append(torch.gather(samples, 0, rows[None, :])[0])
        return tid, ch

    diffuse = (mv[_C_DIFFUSE], mv[_C_DIFFUSE + 1], mv[_C_DIFFUSE + 2])
    if use_diffuse:
        tid, s = slot_sample(0)
        hit = tid >= 0
        diffuse = tuple(torch.where(hit, diffuse[i] * s[i], diffuse[i])
                        for i in range(3))
    metallic, roughness = mv[_C_METALLIC], mv[_C_ROUGHNESS]
    if use_mr:
        tid, s = slot_sample(1)
        hit = tid >= 0
        metallic = torch.where(hit, metallic * s[2], metallic)
        roughness = torch.where(hit, roughness * s[1], roughness)
    spec_colour = (mv[_C_SPEC_COLOUR], mv[_C_SPEC_COLOUR + 1],
                   mv[_C_SPEC_COLOUR + 2])
    if use_spec_col:
        tid, s = slot_sample(8)
        hit = tid >= 0
        spec_colour = tuple(torch.where(hit, spec_colour[i] * s[i], spec_colour[i])
                            for i in range(3))
    spec_factor = mv[_C_SPEC_FACTOR]
    if use_spec:
        tid, s = slot_sample(7)
        spec_factor = torch.where(tid >= 0, spec_factor * s[3], spec_factor)
    emission = (mv[_C_EMISSIVE], mv[_C_EMISSIVE + 1], mv[_C_EMISSIVE + 2])
    if use_emissive:
        tid, s = slot_sample(3)
        hit = tid >= 0
        emission = tuple(torch.where(hit, emission[i] * s[i], emission[i])
                         for i in range(3))

    ninv = 1.0 / torch.clamp(torch.sqrt(_dot_raw(nrm, nrm)), min=1e-12)
    normal = _scale(nrm, ninv)
    if use_normal:
        tid, s = slot_sample(2)
        mn = tuple(s[c] * (255.0 / 127.0) - (128.0 / 127.0) for c in range(3))
        dpx = (P["dpx_x"], P["dpx_y"], P["dpx_z"])
        dpy = (P["dpy_x"], P["dpy_y"], P["dpy_z"])
        dp2perp = (
            dpy[1] * normal[2] - dpy[2] * normal[1],
            dpy[2] * normal[0] - dpy[0] * normal[2],
            dpy[0] * normal[1] - dpy[1] * normal[0],
        )
        dp1perp = (
            normal[1] * dpx[2] - normal[2] * dpx[1],
            normal[2] * dpx[0] - normal[0] * dpx[2],
            normal[0] * dpx[1] - normal[1] * dpx[0],
        )
        t = _add(_scale(dp2perp, P["duvx_u"]), _scale(dp1perp, P["duvy_u"]))
        bt = _add(_scale(dp2perp, P["duvx_v"]), _scale(dp1perp, P["duvy_v"]))
        invmax = 1.0 / torch.sqrt(torch.clamp(
            torch.maximum(_dot_raw(t, t), _dot_raw(bt, bt)), min=1e-20))
        mapped = _add(_add(_scale(t, invmax * mn[0]), _scale(bt, invmax * mn[1])),
                      _scale(normal, mn[2]))
        minv = 1.0 / torch.clamp(torch.sqrt(_dot_raw(mapped, mapped)), min=1e-12)
        hit = tid >= 0
        normal = tuple(torch.where(hit, mapped[i] * minv, normal[i])
                       for i in range(3))

    # light-independent material invariants (pbr/brdf.py::material_invariants)
    ior = mv[_C_IOR]
    ar = roughness * roughness
    c_diff = _scale(diffuse, 1.0 - metallic)
    root = (ior - 1.0) / (ior + 1.0)
    d0 = _scale(spec_colour, (root * root) * spec_factor)
    f0 = tuple(d0[i] + (diffuse[i] - d0[i]) * metallic for i in range(3))
    f90v = spec_factor + (1.0 - spec_factor) * metallic
    m = dict(diffuse=diffuse, ar=ar, c_diff=c_diff, f0=f0,
             f90=(f90v, f90v, f90v))
    if T:
        trans_factor = mv[_C_TRANSMISSION]
        if use_tr:
            tid, s = slot_sample(5)
            trans_factor = torch.where(tid >= 0, trans_factor * s[0], trans_factor)
        thickness = mv[_C_THICKNESS]
        if use_th:
            tid, s = slot_sample(6)
            thickness = torch.where(tid >= 0, thickness * s[1], thickness)
        trans_rough = ar * torch.clamp(ior * 2.0 - 2.0, 0.0, 1.0)

    sc = inp.scalars
    view_vec = (sc[0] - pos[0], sc[1] - pos[1], sc[2] - pos[2])
    vinv = 1.0 / torch.clamp(torch.sqrt(_dot_raw(view_vec, view_vec)), min=1e-12)
    view = _scale(view_vec, vinv)

    ones = torch.ones_like(depth)
    sdir = (sc[3] * ones, sc[4] * ones, sc[5] * ones)
    if inp.sun_f is not None:
        # the ambient floor on the opaque sun (lighting.rs:166); the
        # transmission variant applies the raw factor (:22-37)
        f = inp.sun_f if T else torch.clamp(inp.sun_f, min=0.1)
        sun_i = (sc[6] * f, sc[7] * f, sc[8] * f)
    else:
        sun_i = (sc[6] * ones, sc[7] * ones, sc[8] * ones)
    acc_d, acc_s = _basic_brdf(normal, sdir, sun_i, view, m)
    if T:
        acc_t = _mul(sun_i, _transmission_btdf(normal, sdir, view, m, trans_rough))

    blk = torch.arange(m_pix, device=dev) // 128
    lane = (torch.arange(m_pix, device=dev) % 128).to(torch.float32)
    px = inp.block_px0[blk].to(torch.float32) + lane
    py = inp.block_py[blk].to(torch.float32)
    cluster = pixel_clusters(spec, depth, px, py).long()
    count = inp.counts[cluster]
    lmat = inp.lmat

    for slot in range(inp.indices.shape[1]):
        active = slot < count
        lid = inp.indices[cluster, slot].long()
        lrow = lmat[lid]  # [M, 12]
        vec = (lrow[:, 0] - pos[0], lrow[:, 1] - pos[1], lrow[:, 2] - pos[2])
        dist_sq = _dot_raw(vec, vec)
        dinv = 1.0 / torch.sqrt(dist_sq)
        direction = _scale(vec, dinv)
        attenuation = 1.0 / dist_sq
        factor = torch.where(active, 1.0, 0.0)
        if inp.light_f is not None:
            factor = factor * torch.gather(inp.light_f, 0, lid[None])[0]
        if not T:
            # only evaluate_lights applies the spot factor (lighting.rs:201-203)
            is_spot = lrow[:, 11] > 0.5
            eps = torch.where(lrow[:, 10] == 0.0, 1.0, lrow[:, 10])
            theta = _dot_raw((-direction[0], -direction[1], -direction[2]),
                             (lrow[:, 6], lrow[:, 7], lrow[:, 8]))
            spot = torch.clamp((theta - torch.cos(lrow[:, 9])) / eps, min=0.0)
            factor = factor * torch.where(is_spot, spot, 1.0)
        w = factor * attenuation
        radiance = (lrow[:, 3] * w, lrow[:, 4] * w, lrow[:, 5] * w)
        d, sp = _basic_brdf(normal, direction, radiance, view, m)
        acc_d = _add(acc_d, d)
        acc_s = _add(acc_s, sp)
        if T:
            acc_t = _add(acc_t, _mul(
                radiance, _transmission_btdf(normal, direction, view, m, trans_rough)))

    def masked(vals):
        return [torch.where(valid, v, 0.0) for v in vals]

    if not T:
        return masked(_add(_add(acc_d, acc_s), emission))

    # refraction ray (glam-pbr ibl_volume_refraction, lib.rs:292-345)
    eta = 1.0 / ior
    inc = (-view[0], -view[1], -view[2])
    n_dot_i = _dot_raw(normal, inc)
    kk = 1.0 - eta * eta * (1.0 - n_dot_i * n_dot_i)
    coef = eta * n_dot_i + torch.sqrt(kk)
    refr = tuple(eta * inc[i] - coef * normal[i] for i in range(3))
    rinv = 1.0 / torch.sqrt(_dot_raw(refr, refr))
    ray_len = thickness * P["mscale"]
    exit_p = tuple(pos[i] + refr[i] * rinv * ray_len for i in range(3))

    def dc(row):
        o = 16 + 4 * row
        return ((sc[o] * exit_p[0] + sc[o + 1] * exit_p[1])
                + sc[o + 2] * exit_p[2]) + sc[o + 3]

    dcw = dc(3)
    uv_x = (dc(0) / dcw + 1.0) * 0.5
    uv_y = (dc(1) / dcw + 1.0) * 0.5
    lod = _f32(np.log2(np.float32(spec.fb_width))) * (
        roughness * torch.clamp(ior * 2.0 - 2.0, 0.0, 1.0))
    nov_unclamped = _dot_raw(normal, view)
    att_dist = torch.where(mv[_C_ATT_ISINF] > 0.5, torch.inf, mv[_C_ATT_DIST])
    return masked([
        *acc_d, *acc_s, *acc_t, uv_x, uv_y, lod, ray_len, nov_unclamped,
        roughness, trans_factor, att_dist,
        mv[_C_ATT_COLOUR], mv[_C_ATT_COLOUR + 1], mv[_C_ATT_COLOUR + 2],
        *diffuse, *f0, *m["f90"], *emission,
    ])


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _fused_shade_cuda(inp: ShadeInputs, spec: ShadeSpec) -> list:
    dev = inp.mid.device
    m_pix = inp.mid.shape[0]
    if m_pix % 128:
        raise ValueError(f"{m_pix} pixels: the worklist must be whole 128-px blocks")
    nb = m_pix // 128
    n_mat = inp.mat.shape[0]
    n_lights = inp.lmat.shape[0]
    n_clusters, n_slots = inp.indices.shape
    use_normal = bool(spec.tex_slots[2])
    n_pix = len(PIX_BASE) + (len(PIX_DERIV) if use_normal else 0)
    kernels.check(inp.scalars, "scalars", torch.float32, (32,), device=dev)
    kernels.check(inp.mat, "material matrix", torch.float32, (n_mat, MAT_COLS), device=dev)
    kernels.check(inp.lmat, "light matrix", torch.float32, (n_lights, 12), device=dev)
    kernels.check(inp.counts, "cluster counts", torch.int32, (n_clusters,), device=dev)
    kernels.check(inp.indices, "cluster lights", torch.int32, device=dev)
    kernels.check(inp.block_py, "block_py", torch.int32, (nb,), device=dev)
    kernels.check(inp.block_px0, "block_px0", torch.int32, (nb,), device=dev)
    kernels.check(inp.pix, "pixel planes", torch.float32, (n_pix, m_pix), device=dev)
    kernels.check(inp.mid, "material ids", torch.int32, (m_pix,), device=dev)
    n_samples = inp.samples.shape[0]
    kernels.check(inp.samples, "sample planes", torch.float32, (n_samples, m_pix),
                  device=dev)
    if inp.sun_f is not None:
        kernels.check(inp.sun_f, "sun shadow factor", torch.float32, (m_pix,), device=dev)
    if inp.light_f is not None:
        kernels.check(inp.light_f, "light shadow factors", torch.float32,
                      (n_lights, m_pix), device=dev)
    n_out = N_TRANS_OUT if spec.transmission else 3
    out = torch.empty((n_out, m_pix), dtype=torch.float32, device=dev)
    tex_flags = sum(int(bool(f)) << i for i, f in enumerate(spec.tex_slots))
    iparams = (ctypes.c_int * 19)(
        n_mat, n_lights, n_slots, spec.n_layers, tex_flags, spec.ncx, spec.ncy,
        spec.n_slices, int(spec.transmission), m_pix, n_samples,
        *spec.slot_bundle,
    )
    zn, zf = spec.z_near, spec.z_far
    fparams = (ctypes.c_float * 8)(
        spec.rcp_csx, spec.rcp_csy, np.float32(spec.coeff_scale),
        np.float32(spec.coeff_bias), np.float32(2.0 * zn * zf),
        np.float32(zf + zn), np.float32(zf - zn),
        np.float32(np.log2(np.float32(spec.fb_width))),
    )
    fn = kernels.entry("trt_shade", [
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
        kernels.VOIDP, kernels.VOIDP, kernels.VOIDP, kernels.VOIDP,
        kernels.VOIDP, kernels.VOIDP, kernels.VOIDP, kernels.VOIDP,
        kernels.VOIDP, kernels.VOIDP, kernels.VOIDP, kernels.VOIDP,
        kernels.VOIDP, kernels.VOIDP,
    ])
    kernels.launch(
        KERNEL, fn, iparams, fparams, kernels.ptr(inp.scalars),
        kernels.ptr(inp.mat), kernels.ptr(inp.lmat), kernels.ptr(inp.counts),
        kernels.ptr(inp.indices), kernels.ptr(inp.block_py),
        kernels.ptr(inp.block_px0), kernels.ptr(inp.pix), kernels.ptr(inp.mid),
        kernels.ptr(inp.samples), kernels.ptr(inp.sun_f),
        kernels.ptr(inp.light_f), kernels.ptr(out),
    )
    return list(out)


KERNEL = kernels.KernelHandle(
    "shade", "transmission_renderer_tpu_torch/csrc/shade.cu",
    "transmission_renderer_tpu/render/shade_kernel.py:303",
    cuda=_fused_shade_cuda, plain=fused_shade_plain,
)


def fused_shade(inp: ShadeInputs, spec: ShadeSpec) -> list:
    """Kernel 3 (plain version for CPU tensors)."""
    return KERNEL(inp.mid.is_cuda, inp, spec)


# ---------------------------------------------------------------------------
# frame-facing entry points (the reference's signatures)
# ---------------------------------------------------------------------------

def pallas_shade_supported(ctx, n_mat: int, w: int) -> bool:
    """The reference's gate for the fused kernel, unchanged: the port
    takes the kernel exactly where the JAX package does."""
    S = min(ctx.lights.num, ctx.cluster_light_indices.shape[1])
    return (
        not ctx.debug_clusters
        and not ctx.quad_taps
        and not ctx.bf16_lights
        and (ctx.lights.num <= 16 and S <= 8 or 16 < ctx.lights.num <= 64)
        and w % 128 == 0
        and n_mat <= 128
    )


def _light_matrix(lights) -> torch.Tensor:
    """[L, 12]: position(3) colour_emission(3) spot_direction(3)
    spot_outer_angle spot_epsilon is_spot."""
    return torch.cat(
        [
            lights.position,
            lights.colour_emission,
            lights.spot_direction,
            lights.spot_outer_angle[:, None],
            lights.spot_epsilon[:, None],
            lights.is_a_spotlight().to(torch.float32)[:, None],
        ],
        dim=1,
    )


def _rcp(x: float) -> float:
    return float(np.float32(1.0) / np.float32(x))


def shade_spec(ctx) -> ShadeSpec:
    """The frame-level part of the kernel's static configuration (cluster
    grid and depth slicing) from a ShadeContext; no texture samples."""
    coeffs = ctx.cluster_coeffs
    csx, csy = ctx.cluster_size_in_pixels
    return ShadeSpec(
        n_layers=0, tex_slots=tuple(bool(t) for t in ctx.tex_slots),
        slot_bundle=(0,) * 8, ncx=ctx.num_clusters_xy[0],
        ncy=ctx.num_clusters_xy[1], n_slices=int(coeffs.num_depth_slices),
        rcp_csx=_rcp(csx), rcp_csy=_rcp(csy),
        coeff_scale=float(coeffs.scale), coeff_bias=float(coeffs.bias),
        z_near=float(coeffs.z_near), z_far=float(coeffs.z_far),
        transmission=False, fb_width=float(ctx.framebuffer_size[0]),
    )


def _shade_inputs(g, ctx, block_py, block_px0, sample_list, tex_slots):
    """Assemble the kernel operands from a flat G-buffer and the context."""
    from transmission_renderer_tpu_torch.render.shading import (
        _MAT_SLOTS,
        used_meta_cols,
    )

    dev = g.depth.device
    n_layers = 0
    slot_bundle = (0,) * 8
    if sample_list:
        n_layers = len(sample_list[0]) // 4
        if len(sample_list) > 1:
            used = used_meta_cols(ctx.mat_matrix, tex_slots)
            slot_bundle = tuple(
                used.index(ctx.mat_matrix.meta_col[n])
                if ctx.mat_matrix.meta_col[n] in used else 0
                for n in _MAT_SLOTS
            )
    spec = shade_spec(ctx)._replace(
        n_layers=n_layers, tex_slots=tuple(bool(t) for t in tex_slots),
        slot_bundle=slot_bundle)
    scalars = torch.cat([
        ctx.view_position, ctx.sun_dir, ctx.sun_intensity,
        torch.zeros(7, dtype=torch.float32, device=dev),
        ctx.proj_view.reshape(-1),
    ]).to(torch.float32).contiguous()
    planes = [g.position[:, 0], g.position[:, 1], g.position[:, 2],
              g.normal[:, 0], g.normal[:, 1], g.normal[:, 2], g.depth,
              g.valid.to(torch.float32), g.model_scale]
    if tex_slots[2]:
        planes += [g.dpos_dx[:, 0], g.dpos_dx[:, 1], g.dpos_dx[:, 2],
                   g.dpos_dy[:, 0], g.dpos_dy[:, 1], g.dpos_dy[:, 2],
                   g.duv_dx[:, 0], g.duv_dx[:, 1], g.duv_dy[:, 0], g.duv_dy[:, 1]]
    m_pix = g.depth.shape[0]
    samples = [p for bundle in sample_list for p in bundle]
    s = min(ctx.lights.num, ctx.cluster_light_indices.shape[1])
    sun_f = light_f = None
    if ctx.sun_shadow_factor is not None:
        sun_f = ctx.sun_shadow_factor.to(torch.float32).contiguous()
    if ctx.light_shadow_factors is not None:  # [M, L] -> [L, M] planes
        light_f = ctx.light_shadow_factors.to(torch.float32).T.contiguous()
    inp = ShadeInputs(
        scalars=scalars,
        mat=ctx.mat_matrix.table[:, :MAT_COLS].contiguous(),
        lmat=_light_matrix(ctx.lights).contiguous(),
        counts=ctx.cluster_light_counts.to(torch.int32).contiguous(),
        indices=ctx.cluster_light_indices[:, :s].to(torch.int32).contiguous(),
        block_py=block_py.to(torch.int32).contiguous(),
        block_px0=block_px0.to(torch.int32).contiguous(),
        pix=torch.stack(planes).contiguous(),
        mid=g.material_id.to(torch.int32).contiguous(),
        samples=(torch.stack(samples) if samples else
                 torch.zeros((0, m_pix), dtype=torch.float32, device=dev)),
        sun_f=sun_f,
        light_f=light_f,
    )
    return inp, spec


def shade_opaque_pallas_planes(scene, g, ctx, block_py, block_px0,
                               sample_list: list, tex_slots: tuple) -> tuple:
    """The fused opaque shade -> (r, g, b) [M] planes (oracle:
    the reference's shade_opaque_pallas_planes)."""
    del scene
    inp, spec = _shade_inputs(g, ctx, block_py, block_px0, sample_list, tex_slots)
    return tuple(fused_shade(inp, spec))


def shade_transmission_pallas_pre(scene, g, ctx, block_py, block_px0,
                                  sample_list: list, tex_slots: tuple) -> dict:
    """fragment_transmission up to the framebuffer/LUT fetches -> the 32
    named [M] planes of TRANS_NAMES."""
    del scene
    inp, spec = _shade_inputs(g, ctx, block_py, block_px0, sample_list, tex_slots)
    outs = fused_shade(inp, spec._replace(transmission=True))
    return dict(zip(TRANS_NAMES, outs))
