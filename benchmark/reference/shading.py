"""The plain reference's shading: textures, clustered light lists, the
glTF PBR BRDF, the opaque framebuffer's mip pyramid, rough volume
transmission (KHR_materials_transmission + KHR_materials_volume), the
split-sum GGX table and the Lottes tonemap.

Every equation is written out in float32 plain PyTorch, with each
product and sum rounded on its own, in the order the renderer's shaders
state it. Textures are the configuration's RGBA8 images, decoded (sRGB
or linear), box-filtered into mips in byte space and held in bfloat16,
the texel precision the configuration states; sampling is trilinear
with REPEAT wrapping. Imports nothing of the program under test.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

F32_EPSILON = float(np.finfo(np.float32).eps)
MAX_MIPS = 13


# ---------------------------------------------------------------------------
# textures
# ---------------------------------------------------------------------------

def _box_downsample(img: np.ndarray) -> np.ndarray:
    """2x2 byte-space average, floor(n / 2) sizing."""
    h, w = img.shape[:2]
    nh, nw = max(h // 2, 1), max(w // 2, 1)
    img = img[: nh * 2, : nw * 2].astype(np.float32)
    if h == 1:
        pooled = (img[:, 0::2] + img[:, 1::2]) / 2.0
    elif w == 1:
        pooled = (img[0::2] + img[1::2]) / 2.0
    else:
        pooled = (img[0::2, 0::2] + img[0::2, 1::2] + img[1::2, 0::2] + img[1::2, 1::2]) / 4.0
    return np.round(pooled).astype(np.uint8)


def _decode(img: np.ndarray, srgb: bool) -> np.ndarray:
    f = img.astype(np.float32) / np.float32(255.0)
    if srgb:
        c = f[..., :3]
        lin = np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)
        f = np.concatenate([lin, f[..., 3:]], axis=-1)
    return f.astype(np.float32)


class Texture(NamedTuple):
    levels: tuple  # [h, w, 4] float32 holding bfloat16 values, level 0 first
    width: int
    height: int


def make_texture(rgba: np.ndarray, srgb: bool, device) -> Texture:
    h, w = rgba.shape[:2]
    n = min(int(np.floor(np.log2(max(w, h)))) + 1, MAX_MIPS)
    levels, img = [], rgba
    for m in range(n):
        t = torch.from_numpy(_decode(img, srgb)).to(torch.bfloat16).to(torch.float32)
        levels.append(t.to(device))
        if m + 1 < n:
            img = _box_downsample(img)
    return Texture(tuple(levels), w, h)


def mip_lod(duv_dx, duv_dy, tex_w: int, tex_h: int):
    """log2 of the larger screen-space texel footprint."""
    size = torch.tensor([float(tex_w), float(tex_h)], dtype=torch.float32,
                        device=duv_dx.device)
    fx = duv_dx * size
    fy = duv_dy * size
    rho = torch.maximum(fx[..., 0] * fx[..., 0] + fx[..., 1] * fx[..., 1],
                        fy[..., 0] * fy[..., 0] + fy[..., 1] * fy[..., 1])
    return 0.5 * torch.log2(torch.clamp(rho, min=1e-12))


def _lerp4(c00, c10, c01, c11, fx, fy):
    top = c00 + (c10 - c00) * fx
    bot = c01 + (c11 - c01) * fx
    return top + (bot - top) * fy


def _bilinear_repeat(level: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    h, w = level.shape[:2]
    x = uv[..., 0] * float(w) - 0.5
    y = uv[..., 1] * float(h) - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0f)[..., None], (y - y0f)[..., None]
    x0 = torch.remainder(x0f.to(torch.int32), w).long()
    y0 = torch.remainder(y0f.to(torch.int32), h).long()
    x1, y1 = (x0 + 1) % w, (y0 + 1) % h
    return _lerp4(level[y0, x0], level[y0, x1], level[y1, x0], level[y1, x1], fx, fy)


def sample_trilinear(tex: Texture, uv: torch.Tensor, lod: torch.Tensor) -> torch.Tensor:
    """[..., 4]: the two levels bracketing the clamped lod, blended."""
    lod = torch.clamp(lod, min=0.0)
    l0 = torch.floor(lod).to(torch.int32)
    top = len(tex.levels) - 1
    c0 = torch.zeros(uv.shape[:-1] + (4,), dtype=torch.float32, device=uv.device)
    c1 = torch.zeros_like(c0)
    for k in range(top + 1):
        at0 = torch.clamp(l0, max=top) == k
        at1 = torch.clamp(l0 + 1, max=top) == k
        if bool(at0.any()) or bool(at1.any()):
            ck = _bilinear_repeat(tex.levels[k], uv)
            c0 = torch.where(at0[..., None], ck, c0)
            c1 = torch.where(at1[..., None], ck, c1)
    frac = (lod - l0.to(torch.float32))[..., None]
    return c0 + (c1 - c0) * frac


# ---------------------------------------------------------------------------
# materials
# ---------------------------------------------------------------------------

class Materials(NamedTuple):
    diffuse: torch.Tensor  # [M, 4]
    metallic: torch.Tensor
    roughness: torch.Tensor
    emissive: torch.Tensor  # [M, 3]
    ior: torch.Tensor
    transmission: torch.Tensor
    thickness: torch.Tensor
    attenuation_distance: torch.Tensor
    attenuation_colour: torch.Tensor  # [M, 3]
    specular: torch.Tensor
    specular_colour: torch.Tensor  # [M, 3]
    cutoff: torch.Tensor
    tex_diffuse: list  # per material: texture index or -1


UNSUPPORTED_SLOTS = ("tex_metallic_roughness", "tex_normal_map", "tex_emissive",
                     "tex_transmission", "tex_thickness", "tex_specular",
                     "tex_specular_colour")


def make_materials(rows: list, device) -> Materials:
    for r in rows:
        used = [s for s in UNSUPPORTED_SLOTS if r[s] >= 0]
        if used:
            raise NotImplementedError(f"the reference samples diffuse textures only: {used}")

    def col(key, width=None):
        a = np.array([r[key] for r in rows], np.float32)
        return torch.from_numpy(a if width is None else a.reshape(-1, width)).to(device)

    return Materials(
        diffuse=col("diffuse_factor", 4), metallic=col("metallic_factor"),
        roughness=col("roughness_factor"), emissive=col("emissive_factor", 3),
        ior=col("index_of_refraction"), transmission=col("transmission_factor"),
        thickness=col("thickness_factor"), attenuation_distance=col("attenuation_distance"),
        attenuation_colour=col("attenuation_colour", 3), specular=col("specular_factor"),
        specular_colour=col("specular_colour_factor", 3), cutoff=col("alpha_clipping_cutoff"),
        tex_diffuse=[int(r["tex_diffuse"]) for r in rows],
    )


def diffuse_sample(mats: Materials, textures: list, mat: torch.Tensor, uv, duv_dx, duv_dy):
    """[..., 4] diffuse factor times its texture (trilinear, at the
    implicit LOD) where the material has one."""
    out = mats.diffuse[mat]
    for m, t in enumerate(mats.tex_diffuse):
        if t < 0:
            continue
        sel = torch.nonzero(mat == m)[:, 0]
        if sel.numel() == 0:
            continue
        tex = textures[t]
        lod = mip_lod(duv_dx[sel], duv_dy[sel], tex.width, tex.height)
        out[sel] = out[sel] * sample_trilinear(tex, uv[sel], lod)
    return out


# ---------------------------------------------------------------------------
# clustered light lists
# ---------------------------------------------------------------------------

class Clusters(NamedTuple):
    z_near: float
    z_far: float
    scale: float
    bias: float
    slices: int
    ncx: int
    ncy: int
    rcp_x: float
    rcp_y: float
    accept: torch.Tensor  # [C, L] bool: light l's sphere reaches cluster c


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(np.float32(x), device=device)


def linear_depth(c: Clusters, depth: torch.Tensor) -> torch.Tensor:
    zn, zf = c.z_near, c.z_far
    depth_range = 2.0 * (1.0 - depth) - 1.0
    return _f32(2.0 * zn * zf, depth.device) / ((zf + zn) - depth_range * (zf - zn))


def make_clusters(cfg: dict, view: torch.Tensor, light_pos: torch.Tensor,
                  falloff_sq: torch.Tensor, inverse_projection: np.ndarray) -> Clusters:
    """Cluster AABBs in view space (a screen grid of ncx x ncy tiles by
    logarithmic depth slices), each light accepted where its falloff
    sphere reaches the AABB."""
    zn, zf, slices = cfg["z_near"], cfg["z_far"], cfg["num_depth_slices"]
    ncx, ncy = cfg["num_clusters_x"], cfg["num_clusters_y"]
    width, height = cfg["width"], cfg["height"]
    log_ratio = np.log2(zf / zn)
    scale = slices / log_ratio
    bias = -(slices * np.log2(zn) / log_ratio)
    inv = torch.from_numpy(inverse_projection.astype(np.float32))
    size = torch.tensor(np.array([width / ncx, height / ncy], np.float32))
    gz, gy, gx = torch.meshgrid(torch.arange(slices, dtype=torch.float32),
                                torch.arange(ncy, dtype=torch.float32),
                                torch.arange(ncx, dtype=torch.float32), indexing="ij")
    xy = torch.stack([gx, gy], dim=-1)
    dims = torch.tensor(np.array([width, height], np.float32))

    def screen_to_view(pos):
        clip = pos / dims * 2.0 - 1.0
        clip4 = torch.cat([clip, torch.zeros_like(clip[..., :1]),
                           torch.ones_like(clip[..., :1])], dim=-1)
        v = clip4 @ inv.T
        return v[..., :3] / v[..., 3:4]

    def slice_z(k):
        t = k / _f32(slices, "cpu")
        return np.float32(-zn) * torch.pow(_f32(zf / zn, "cpu"), t)

    def to_plane(a, b, z):
        ab = b - a
        t = (z - a[..., 2]) / ab[..., 2]
        return a + t[..., None] * ab

    vmin, vmax = screen_to_view(xy * size), screen_to_view((xy + 1.0) * size)
    near, far = slice_z(gz), slice_z(gz + 1.0)
    eye = torch.tensor([0.0, 0.0, 1.0])
    pts = torch.stack([to_plane(eye, vmin, near), to_plane(eye, vmin, far),
                       to_plane(eye, vmax, near), to_plane(eye, vmax, far)])
    dev = view.device
    amin = pts.amin(dim=0).reshape(-1, 3).to(dev)
    amax = pts.amax(dim=0).reshape(-1, 3).to(dev)
    lp = torch.cat([light_pos, torch.ones_like(light_pos[:, :1])], -1)
    lview = (lp @ view.T)[:, :3]
    d = torch.clamp(torch.maximum(amin[:, None] - lview[None], lview[None] - amax[:, None]),
                    min=0.0)
    d_sq = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    accept = d_sq <= falloff_sq[None, :]
    rcp = lambda x: float(np.float32(1.0) / np.float32(x))  # noqa: E731
    return Clusters(zn, zf, float(scale), float(bias), slices, ncx, ncy,
                    rcp(width / ncx), rcp(height / ncy), accept)


def cluster_of(c: Clusters, depth, px, py) -> torch.Tensor:
    s = (torch.log2(linear_depth(c, depth)) * float(np.float32(c.scale))
         + float(np.float32(c.bias)))
    zsl = torch.clamp(torch.clamp(s, min=0.0).to(torch.int32), max=c.slices - 1)
    cx = torch.clamp(((px.to(torch.float32) + 0.5) * c.rcp_x).to(torch.int32), max=c.ncx - 1)
    cy = torch.clamp(((py.to(torch.float32) + 0.5) * c.rcp_y).to(torch.int32), max=c.ncy - 1)
    return zsl * (c.ncx * c.ncy) + cy * c.ncx + cx


# ---------------------------------------------------------------------------
# the glTF PBR BRDF and BTDF
# ---------------------------------------------------------------------------

class Surface(NamedTuple):
    diffuse_colour: torch.Tensor  # [M, 3]
    metallic: torch.Tensor
    roughness: torch.Tensor  # perceptual
    ior: torch.Tensor
    specular_colour: torch.Tensor  # [M, 3]
    specular: torch.Tensor


def _sum3(v):
    return (v[..., 0] + v[..., 1]) + v[..., 2]


def _dot(a, b):
    return torch.clamp(_sum3(a * b), min=F32_EPSILON)


def _normalize(v):
    return v / torch.sqrt(_sum3(v * v))[..., None]


def normalize_safe(v):
    return v / torch.clamp(torch.sqrt(_sum3(v * v)), min=1e-12)[..., None]


def d_ggx(noh, a):
    a2 = a * a
    f = (noh * noh) * (a2 - 1.0) + 1.0
    return torch.where(f * f > 0.0, a2 / (math.pi * f * f), 0.0)


def v_smith(nov, nol, a):
    a2 = a * a
    ggx = nol * torch.sqrt(nov * nov * (1.0 - a2) + a2) + nov * torch.sqrt(nol * nol * (1.0 - a2) + a2)
    return torch.where(ggx > 0.0, 0.5 / ggx, 0.0)


def fresnel(voh, f0, f90):
    return f0 + (f90 - f0) * (1.0 - voh[..., None]) ** 5.0


def ior_roughness(r, ior):
    return r * torch.clamp(ior * 2.0 - 2.0, 0.0, 1.0)


def f0_f90(s: Surface):
    root = (s.ior - 1.0) / (s.ior + 1.0)
    dielectric = (root * root)[..., None] * s.specular_colour * s.specular[..., None]
    f0 = dielectric + (s.diffuse_colour - dielectric) * s.metallic[..., None]
    d90 = s.specular[..., None].expand(s.diffuse_colour.shape)
    f90 = d90 + (1.0 - d90) * s.metallic[..., None]
    return f0, f90


def brdf(s: Surface, normal, light, intensity, view):
    """(diffuse, specular) [M, 3] of one light."""
    a = s.roughness * s.roughness
    c_diff = s.diffuse_colour * (1.0 - s.metallic[..., None])
    f0, f90 = f0_f90(s)
    h = _normalize(view + light)
    noh, nov, nol, voh = _dot(normal, h), _dot(normal, view), _dot(normal, light), _dot(view, h)
    f = fresnel(voh, f0, f90)
    radiance = intensity * nol[..., None]
    fmax = torch.amax(f, dim=-1, keepdim=True)
    diffuse = radiance * ((1.0 - fmax) * (1.0 / math.pi) * c_diff)
    specular = (radiance * (d_ggx(noh, a) * v_smith(nov, nol, a))[..., None]) * f
    return diffuse, specular


def btdf(s: Surface, normal, view, light):
    """[M, 3] rough transmission lobe of one light."""
    a = s.roughness * s.roughness
    rough = ior_roughness(a, s.ior)
    f0, f90 = f0_f90(s)
    l_dot_n = _sum3(-light * normal)[..., None]
    mirrored = _normalize(light + 2.0 * normal * l_dot_n)
    h = _normalize(view + mirrored)
    noh, voh, nov = _dot(normal, h), _dot(view, h), _dot(normal, view)
    dv = d_ggx(noh, rough) * v_smith(nov, _dot(normal, mirrored), rough)
    return ((1.0 - fresnel(voh, f0, f90)) * dv[..., None]) * s.diffuse_colour


def lights_loop(s: Surface, normal, view, position, sun_dir, sun_intensity, lights: dict,
                in_list, shadow_sun=None, shadow_lights=None, transmission=False):
    """The sun and every light of the pixel's cluster list (lights in id
    order) -> (diffuse, specular, transmitted or None)."""
    sun_f = torch.ones_like(position[..., 0]) if shadow_sun is None else shadow_sun
    if not transmission and shadow_sun is not None:
        sun_f = torch.clamp(sun_f, min=0.1)
    sun_i = sun_intensity * sun_f[..., None]
    sun = sun_dir.expand(position.shape)
    diffuse, specular = brdf(s, normal, sun, sun_i, view)
    trans = sun_i * btdf(s, normal, view, sun) if transmission else None
    for li in range(lights["position"].shape[0]):
        vec = lights["position"][li] - position
        dist_sq = _sum3(vec * vec)
        direction = vec / torch.sqrt(dist_sq)[..., None]
        factor = in_list[..., li].to(torch.float32)
        if shadow_lights is not None:
            factor = factor * shadow_lights[..., li]
        radiance = lights["colour"][li] * factor[..., None] * (1.0 / dist_sq)[..., None]
        d, sp = brdf(s, normal, direction, radiance, view)
        diffuse, specular = diffuse + d, specular + sp
        if transmission:
            trans = trans + radiance * btdf(s, normal, view, direction)
    return diffuse, specular, trans


# ---------------------------------------------------------------------------
# the framebuffer pyramid and the split-sum table
# ---------------------------------------------------------------------------

def pyramid(hdr: torch.Tensor) -> list:
    """[3, H, W] -> every level of the 2x2 box chain (floor(n / 2) sizing)."""
    levels = [hdr]
    h, w = hdr.shape[-2:]
    for _ in range(int(np.floor(np.log2(max(w, h))))):
        img = levels[-1]
        h, w = img.shape[-2:]
        nh, nw = max(h // 2, 1), max(w // 2, 1)
        if h == 1:
            nxt = (img[..., :, 0:2 * nw:2] + img[..., :, 1:2 * nw:2]) * 0.5
        elif w == 1:
            nxt = (img[..., 0:2 * nh:2, :] + img[..., 1:2 * nh:2, :]) * 0.5
        else:
            nxt = ((img[..., 0:2 * nh:2, 0:2 * nw:2] + img[..., 0:2 * nh:2, 1:2 * nw:2])
                   + (img[..., 1:2 * nh:2, 0:2 * nw:2] + img[..., 1:2 * nh:2, 1:2 * nw:2])) * 0.25
        levels.append(nxt)
    return levels


def _bilinear_clamp(level: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    _, h, w = level.shape
    x = uv[..., 0] * float(w) - 0.5
    y = uv[..., 1] * float(h) - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = x - x0f, y - y0f
    x0, y0 = x0f.to(torch.int32), y0f.to(torch.int32)
    fx = torch.where(x0 < 0, 0.0, fx)[..., None]
    fy = torch.where(y0 < 0, 0.0, fy)[..., None]
    x0 = torch.clamp(x0, 0, w - 1).long()
    y0 = torch.clamp(y0, 0, h - 1).long()
    x1, y1 = torch.clamp(x0 + 1, max=w - 1), torch.clamp(y0 + 1, max=h - 1)
    t = level.permute(1, 2, 0)
    return _lerp4(t[y0, x0], t[y0, x1], t[y1, x0], t[y1, x1], fx, fy)


def sample_pyramid(levels: list, uv: torch.Tensor, lod: torch.Tensor) -> torch.Tensor:
    """Tent-weighted blend of the two levels bracketing the lod."""
    hi = len(levels) - 1
    lod = torch.clamp(lod, 0.0, float(hi))
    l0 = torch.floor(lod).to(torch.int32)
    l1 = torch.clamp(l0 + 1, max=hi)
    l0f = l0.to(torch.float32)
    w0 = torch.clamp(1.0 - torch.abs(lod - l0f), 0.0, 1.0)
    w1 = torch.where(l1 == l0, 0.0, torch.clamp(1.0 - torch.abs(lod - (l0f + 1.0)), 0.0, 1.0))
    c0 = torch.zeros(uv.shape[:-1] + (3,), dtype=torch.float32, device=uv.device)
    c1 = torch.zeros_like(c0)
    for k in range(hi + 1):
        at0, at1 = l0 == k, l1 == k
        if bool(at0.any()) or bool(at1.any()):
            ck = _bilinear_clamp(levels[k], uv)
            c0 = torch.where(at0[..., None], ck, c0)
            c1 = torch.where(at1[..., None], ck, c1)
    return c0 * w0[..., None] + c1 * w1[..., None]


def _hammersley(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.uint32)
    bits = ((i << 16) | (i >> 16)) & 0xFFFFFFFF
    bits = ((bits & 0x55555555) << 1) | ((bits & 0xAAAAAAAA) >> 1)
    bits = ((bits & 0x33333333) << 2) | ((bits & 0xCCCCCCCC) >> 2)
    bits = ((bits & 0x0F0F0F0F) << 4) | ((bits & 0xF0F0F0F0) >> 4)
    bits = ((bits & 0x00FF00FF) << 8) | ((bits & 0xFF00FF00) >> 8)
    return np.stack([i.astype(np.float64) / n, bits.astype(np.float64) * 2.3283064365386963e-10], -1)


def ggx_table(size: int = 128, samples: int = 512) -> np.ndarray:
    """The split-sum GGX table [size, size, 2] (scale, bias): Karis's
    importance-sampled integral with height-correlated Smith visibility
    over Hammersley points, stored with the roughness axis running
    downward (the glTF viewer's ggx_lut.png layout) and quantised to UNORM8."""
    xi = _hammersley(samples)
    nov = (np.arange(size, dtype=np.float64) + 0.5) / size
    nov_g, rough_g = np.meshgrid(nov, nov)
    a = rough_g ** 2
    vx, vz = np.sqrt(1.0 - nov_g ** 2), nov_g
    scale = np.zeros_like(nov_g)
    bias = np.zeros_like(nov_g)
    for u1, u2 in xi:
        phi = 2.0 * np.pi * u1
        cos_t = np.sqrt((1.0 - u2) / (1.0 + (a ** 2 - 1.0) * u2))
        sin_t = np.sqrt(np.maximum(1.0 - cos_t ** 2, 0.0))
        hx, hz = sin_t * np.cos(phi), cos_t
        voh_raw = vx * hx + vz * hz
        nol = np.maximum(2 * voh_raw * hz - vz, 0.0)
        noh, voh = np.maximum(hz, 0.0), np.maximum(voh_raw, 0.0)
        a2 = a ** 2
        g = nol * np.sqrt(nov_g ** 2 * (1 - a2) + a2) + nov_g * np.sqrt(nol ** 2 * (1 - a2) + a2)
        vis = np.where(g > 0, 0.5 / np.maximum(g, 1e-12), 0.0)
        weight = np.where((nol > 0) & (noh > 0), vis * 4.0 * voh * nol / np.maximum(noh, 1e-12), 0.0)
        fc = (1.0 - voh) ** 5
        scale += (1.0 - fc) * weight
        bias += fc * weight
    lut = np.stack([scale / samples, bias / samples], -1).astype(np.float32)[::-1]
    return np.round(lut * 255.0).astype(np.float32) / np.float32(255.0)


def sample_table(lut: torch.Tensor, u, v) -> torch.Tensor:
    """Clamp-to-edge bilinear tap of the [S, S, 2] table."""
    s = lut.shape[0]
    x = torch.clamp(u * s - 0.5, 0.0, s - 1.0)
    y = torch.clamp(v * s - 0.5, 0.0, s - 1.0)
    x0, y0 = torch.floor(x).to(torch.int32), torch.floor(y).to(torch.int32)
    fx, fy = (x - x0.to(torch.float32))[..., None], (y - y0.to(torch.float32))[..., None]
    x1, y1 = torch.clamp(x0 + 1, max=s - 1).long(), torch.clamp(y0 + 1, max=s - 1).long()
    x0, y0 = x0.long(), y0.long()
    return _lerp4(lut[y0, x0], lut[y0, x1], lut[y1, x0], lut[y1, x1], fx, fy)


def volume_refraction(s: Surface, width: int, normal, view, proj_view, position, thickness,
                      model_scale, att_dist, att_colour, levels: list, lut) -> torch.Tensor:
    """The refracted view ray's exit point through a volume of the
    material's thickness, the opaque framebuffer sampled there at lod
    log2(width) * roughness (after the IOR), Beer's-law attenuation, and
    the split-sum specular's complement."""
    eta = 1.0 / s.ior
    incident = -view
    n_dot_i = _sum3(normal * incident)
    k = 1.0 - eta * eta * (1.0 - n_dot_i * n_dot_i)
    refraction = eta[..., None] * incident - (eta * n_dot_i + torch.sqrt(k))[..., None] * normal
    length = thickness * model_scale
    exit_point = position + _normalize(refraction) * length[..., None]
    h = torch.cat([exit_point, torch.ones_like(exit_point[..., :1])], dim=-1) @ proj_view.T
    uv = (h[..., :2] / h[..., 3:4] + 1.0) / 2.0
    log2_w = torch.log2(torch.tensor(float(width), device=position.device))
    transmitted = sample_pyramid(levels, uv, log2_w * ior_roughness(s.roughness, s.ior))
    coefficient = -torch.log(att_colour) / att_dist[..., None]
    attenuated = torch.where(torch.isinf(att_dist)[..., None], transmitted,
                             torch.exp(-coefficient * length[..., None]) * transmitted)
    split = sample_table(lut, _sum3(normal * view), s.roughness)
    f0, f90 = f0_f90(s)
    return (1.0 - (f0 * split[..., 0:1] + f90 * split[..., 1:2])) * attenuated * s.diffuse_colour


# ---------------------------------------------------------------------------
# the Lottes tonemap
# ---------------------------------------------------------------------------

def _powf(x, e):
    return (x.to(torch.float64) ** float(e)).to(torch.float32)


def tonemap(r, g, b) -> torch.Tensor:
    """Max-channel, ratio-preserving Lottes curve (contrast 1.35, shoulder
    0.99, white 25, grey 0.18 -> 0.18, crosstalk 10, saturation 1,
    cross-saturation 1.33) -> [..., 3] in [0, 1]."""
    a, d, gi, go, lm = 1.35, 0.99, 0.18, 0.18, 25.0
    denom = (lm ** (a * d) - gi ** (a * d)) * go
    bb = np.float32((-gi ** a + lm ** a * go) / denom)
    cc = np.float32((lm ** (a * d) * gi ** a - lm ** a * gi ** (a * d) * go) / denom)
    a32, d32 = np.float32(a), np.float32(d)
    crosstalk, sat, cross_sat = np.float32(10.0), np.float32(1.0), np.float32(1.33)
    r, g, b = (torch.clamp(c, min=0.0) for c in (r, g, b))
    max_c = torch.maximum(torch.maximum(r, g), b)
    safe = torch.clamp(max_c, min=1e-30)
    z = _powf(max_c, a32)
    mapped = z / (_powf(z, d32) * float(bb) + float(cc))
    ct = _powf(mapped, crosstalk)
    ratio_e = float(sat / cross_sat)

    def chan(c):
        ratio = _powf(c / safe, ratio_e)
        ratio = ratio + (1.0 - ratio) * ct
        return torch.clamp(_powf(ratio, cross_sat) * mapped, 0.0, 1.0)

    return torch.stack([chan(r), chan(g), chan(b)], dim=-1)
