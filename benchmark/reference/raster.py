"""The plain reference's rasteriser: a z-buffer by a 64-bit scatter-max.

Every triangle is tested at every pixel of its screen bounding box and
one pixel around it (every pixel for a triangle with a vertex behind the
eye), by its homogeneous edge functions (the adjugate of its [x, y, w]
clip matrix), with the top-left fill rule; a fragment is kept where
w > 0 and its reversed-Z depth lies in [0, 1]. No pixel whose centre
lies outside that box lies inside the triangle, so a pixel beyond it is
never drawn, even where a sliver's float32 edge functions round to
"inside" there. The nearest fragment wins a pixel, ties going to the
lower triangle id: each fragment scatters the key (depth bits << 32 |
2^32 - 2 - triangle id) and the largest key wins.
Alpha-clip triangles scatter only their fragments whose diffuse alpha
(trilinear, at the LOD of their analytic uv derivatives) reaches the
material's cutoff. The winners' attributes are interpolated
perspective-correct, with closed-form screen derivatives of the uvs.
"""

from __future__ import annotations

import torch

KEY_LOW = 0xFFFFFFFF
# fragments per chunk of the scatter (bounds the reference's memory)
CHUNK = 1 << 23


def _fma(a, b, c):
    f64 = torch.float64
    return (a.to(f64) * b.to(f64) + c.to(f64)).to(torch.float32)


def _det3(m: torch.Tensor) -> torch.Tensor:
    """Rule of Sarrus, the first five products chained through fused
    multiply-adds: the sign that decides the backface cull of degenerate
    triangles matches the renderer's."""
    def g(i, j):
        return m[..., i, j]

    s = _fma(g(0, 0) * g(1, 1), g(2, 2), g(0, 1) * g(1, 2) * g(2, 0))
    s = _fma(g(0, 2) * g(1, 0), g(2, 1), s)
    s = _fma(-(g(0, 2) * g(1, 1)), g(2, 0), s)
    s = _fma(-(g(0, 0) * g(1, 2)), g(2, 1), s)
    return s - g(0, 1) * g(1, 0) * g(2, 2)


def _adjugate3(m: torch.Tensor) -> torch.Tensor:
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
    ], dim=-2)


def _pixel(v: torch.Tensor, n: int) -> torch.Tensor:
    """clip(v, 0, n - 1) as a pixel index, NaN reading 0."""
    return torch.clamp(torch.nan_to_num(v, nan=0.0), 0, n - 1).to(torch.int64)


def setup(clip: torch.Tensor, tri_vtx: torch.Tensor, enabled: torch.Tensor, width: int,
          height: int):
    """-> (records [T, 15]: the three edge rows (a, b, c), z and w of the
    vertices; front-facing and on-screen mask [T]; the pixel box [T, 4]
    inclusive (x0, y0, x1, y1) of the screen bounding box and a pixel
    around it, the whole screen for a triangle with a vertex behind the
    eye)."""
    v = clip[tri_vtx]  # [T, 3, 4]
    x, y, z, w = v.unbind(-1)
    m = torch.stack([x, y, w], dim=-2)
    edges = -_adjugate3(m)
    valid = enabled & (_det3(m) < 0.0)
    safe_w = torch.clamp(w, min=1e-30)
    sx = (x / safe_w + 1.0) * (0.5 * width)
    sy = (y / safe_w + 1.0) * (0.5 * height)
    behind = torch.any(w <= 1e-6, dim=-1)
    x0 = torch.where(behind, 0.0, sx.amin(-1))
    x1 = torch.where(behind, float(width), sx.amax(-1))
    y0 = torch.where(behind, 0.0, sy.amin(-1))
    y1 = torch.where(behind, float(height), sy.amax(-1))
    valid &= behind | ((x1 > 0) & (x0 < width) & (y1 > 0) & (y0 < height))
    valid &= ~torch.all(w <= 0.0, dim=-1)
    bbox = torch.stack([
        torch.where(behind, 0, _pixel(torch.floor(x0) - 1.0, width)),
        torch.where(behind, 0, _pixel(torch.floor(y0) - 1.0, height)),
        torch.where(behind, width - 1, _pixel(torch.floor(x1) + 1.0, width)),
        torch.where(behind, height - 1, _pixel(torch.floor(y1) + 1.0, height)),
    ], dim=-1)
    records = torch.cat([edges.reshape(-1, 9), z, w], dim=1)
    return records, valid, bbox


def pixel_ndc(px: torch.Tensor, py: torch.Tensor, width: int, height: int):
    """NDC of the pixels' centres."""
    nx = (px.to(torch.float32) + 0.5) * (2.0 / width) - 1.0
    ny = (py.to(torch.float32) + 0.5) * (2.0 / height) - 1.0
    return nx, ny


def edge_values(r, nx, ny):
    """The three edge functions of records r [..., >= 9] at (nx, ny)."""
    return (r[..., 0] * nx + r[..., 1] * ny + r[..., 2],
            r[..., 3] * nx + r[..., 4] * ny + r[..., 5],
            r[..., 6] * nx + r[..., 7] * ny + r[..., 8])


def fragment_test(r, e):
    """(inside, depth): top-left coverage, w > 0, depth in [0, 1]."""
    def covered(ev, a, b):
        top_left = (a > 0) | ((a == 0) & (b > 0))
        return (ev > 0) | ((ev == 0) & top_left)

    e0, e1, e2 = e
    inside = (covered(e0, r[..., 0], r[..., 1]) & covered(e1, r[..., 3], r[..., 4])
              & covered(e2, r[..., 6], r[..., 7]))
    w_int = e0 * r[..., 12] + e1 * r[..., 13] + e2 * r[..., 14]
    depth = (e0 * r[..., 9] + e1 * r[..., 10] + e2 * r[..., 11]) / w_int
    inside &= (w_int > 0) & (depth >= 0.0) & (depth <= 1.0)
    return inside, depth


def interpolate(r, attrs, e, width: int, height: int, derivs: bool):
    """Perspective-correct attributes of records r at edge values e:
    attrs [..., 3, C] per vertex -> (values [..., C], d/dx, d/dy) with
    the derivatives taken in closed form (None when not asked)."""
    e0, e1, e2 = e
    a0, b0, a1, b1, a2, b2 = (r[..., i] for i in (0, 1, 3, 4, 6, 7))
    d_sum = e0 + e1 + e2
    inv_d = 1.0 / d_sum
    A0, A1, A2 = attrs[..., 0, :], attrs[..., 1, :], attrs[..., 2, :]
    n_attr = e0[..., None] * A0 + e1[..., None] * A1 + e2[..., None] * A2
    value = n_attr * inv_d[..., None]
    if not derivs:
        return value, None, None
    a_sum = a0 + a1 + a2
    b_sum = b0 + b1 + b2
    inv_d2x = inv_d * inv_d * (2.0 / width)
    inv_d2y = inv_d * inv_d * (2.0 / height)
    na = a0[..., None] * A0 + a1[..., None] * A1 + a2[..., None] * A2
    nb = b0[..., None] * A0 + b1[..., None] * A1 + b2[..., None] * A2
    ddx = (na * d_sum[..., None] - n_attr * a_sum[..., None]) * inv_d2x[..., None]
    ddy = (nb * d_sum[..., None] - n_attr * b_sum[..., None]) * inv_d2y[..., None]
    return value, ddx, ddy


def zbuffer(records, bbox, tris: torch.Tensor, width: int, height: int, seed_depth=None,
            keep=None) -> torch.Tensor:
    """Nearest fragment of the triangles ``tris`` [n] at every pixel ->
    keys [H * W] int64 (0: no fragment). Only fragments strictly nearer
    than ``seed_depth`` [H * W] count (a cleared depth is 0).
    ``keep(tri, px, py, e)`` may drop fragments (the alpha test)."""
    dev = records.device
    keys = torch.zeros(height * width, dtype=torch.int64, device=dev)
    if seed_depth is None:
        seed_depth = torch.zeros(height * width, dtype=torch.float32, device=dev)
    if tris.numel() == 0:
        return keys
    bb = bbox[tris]
    bw = bb[:, 2] - bb[:, 0] + 1
    count = bw * (bb[:, 3] - bb[:, 1] + 1)
    ends = torch.cumsum(count, 0)
    starts = ends - count
    lo = 0
    n = tris.numel()
    while lo < n:
        # triangles [lo, hi) hold at most CHUNK fragments (one big triangle alone)
        limit = int(starts[lo]) + CHUNK
        hi = max(lo + 1, int(torch.searchsorted(ends, limit, right=True)))
        hi = min(hi, n)
        cnt = count[lo:hi]
        local = torch.repeat_interleave(torch.arange(lo, hi, device=dev), cnt)
        off = torch.arange(int(cnt.sum()), device=dev) - (starts[local] - starts[lo])
        px = bb[local, 0] + off % bw[local]
        py = bb[local, 1] + off // bw[local]
        tri = tris[local]
        r = records[tri]
        e = edge_values(r, *pixel_ndc(px, py, width, height))
        inside, depth = fragment_test(r, e)
        pix = py * width + px
        inside &= depth > seed_depth[pix]
        if keep is not None:
            sel = torch.nonzero(inside)[:, 0]
            ok = keep(tri[sel], px[sel], py[sel], tuple(v[sel] for v in e))
            inside[sel[~ok]] = False
        bits = (depth + 0.0).view(torch.int32).to(torch.int64)
        key = (bits << 32) | (KEY_LOW - 1 - tri)
        sel = torch.nonzero(inside)[:, 0]
        keys.scatter_reduce_(0, pix[sel], key[sel], "amax")
        lo = hi
    return keys


def winners(keys: torch.Tensor):
    """-> (valid [N] bool, triangle id [N] int64, depth [N] float32)."""
    valid = keys != 0
    tri = torch.where(valid, KEY_LOW - 1 - (keys & KEY_LOW), -1)
    depth = torch.where(valid, (keys >> 32).to(torch.int32).view(torch.float32), 0.0)
    return valid, tri, depth
