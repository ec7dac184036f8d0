"""Row-band-sharded render_frame over torch.distributed.

Counterpart of ``transmission_renderer_tpu/parallel/sharded.py``
(make_band_mesh, _band_tile_rows, _trailing_zeros, _BandPyramidSpec,
_build_band_pyramid, _sample_band_pyramid, render_frame_sharded). The
reference runs one SPMD program under ``shard_map``; here every rank of
a process group calls ``render_frame_sharded`` with the same (replicated)
scene and its ``BandMesh``, and the collectives below take the place of
the mesh axis's ``all_gather``, ``ppermute``, ``pmax`` and ``psum``.

Each rank owns a band of ``ceil(tiles_y / n)`` tile rows (the grid is
padded to a multiple of the band count; padded rows raster nothing and
are cropped):

- the vertex transform, cull, binning (over the padded grid) and light
  clusters are computed on every rank;
- the band rasterises only its tiles: kernel 1 on the G-buffer branch
  (its depth peel band-local), or kernel 6 and interpolate_gbuffer with
  the band's row offset on the visibility branch;
- shading runs band-locally with global pixel rows (kernels 2 and 3 with
  the band's block rows);
- the opaque mip pyramid is distributed: fine levels stay band-local with
  ``halo_px >> l`` rows exchanged with each neighbour, one coarse level is
  gathered and the rest derived on every rank. A refraction fetch within
  the halo is exact; one farther out clamps to the halo's edge, as the
  reference's does. The transmission shade is dense per band and fetches
  through this band pyramid (kernel 4 does not run, as in the reference,
  whose fused fetch runs only without a caller's sampler);
- ray-traced shadows are band-local (kernel 5 on the band's pixels); the
  half-res form upsamples with a one-row halo from the band below;
- diagnostics are reduced across bands (max for capacities, sum for
  unresolved pixels), and the tonemapped bands are gathered, so every
  rank returns the whole frame.

One departure from the reference: on the G-buffer branch the bins use
render_frame's tier ladder (``config.pallas_tiers``). The reference's
sharded frame bins with its older mid and giant lists, whose 512-slot
mid list the 1080p flagship overflows (1857 triangles), so it drops
triangles there; its FrameDiagnostics say so. The diagnostics here are
render_frame's for the ladder (the giant rung's demand and capacity, the
worst rung's overflow).

The pyramid stays planar: the reference's quad-block pool is a TPU gather
layout. The sampler keeps its slice-edge rules (the global clamp before
the slice remap, ``fy`` forced to 0 where the quad build duplicated a
row), so it fetches the same texels.

Collectives go through NCCL when each rank owns a card, and through gloo
on the CPU or for ranks that share one card (NCCL refuses two ranks on
one device); gloo then moves CUDA tensors through host memory. Kernels
launch on PyTorch's current stream, and a staged collective copies to
the host (which waits for that stream) before it sends.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from transmission_renderer_tpu_torch.config import (
    BUCKET_ALPHA_CLIP,
    BUCKET_OPAQUE,
    BUCKET_TRANSMISSION,
    BUCKET_TRANSMISSION_ALPHA_CLIP,
    RenderConfig,
)
from transmission_renderer_tpu_torch.ops.bvh import refit_bvh
from transmission_renderer_tpu_torch.ops.cull import (
    bucket_triangle_masks,
    cull_instances,
    transform_vertices,
)
from transmission_renderer_tpu_torch.ops.mipchain import _downsample2x, pyramid_shapes
from transmission_renderer_tpu_torch.ops.raster import (
    VisibilityBuffer,
    bin_triangles,
    bin_triangles_materialized,
    setup_triangles,
    tile_image,
    untile_image,
)
from transmission_renderer_tpu_torch.ops.raster_gbuf import (
    TILE_H,
    TILE_W,
    gather_gbuf_payload,
    gbuffer_from_channels,
    pack_gbuf_payload,
    rasterize_gbuffer_tiles,
)
from transmission_renderer_tpu_torch.ops.raster_vis import rasterize_tilelist
from transmission_renderer_tpu_torch.pbr.tonemap import bake_lottes_params, lottes_tonemap_planes
from transmission_renderer_tpu_torch.render.frame import (
    FrameDiagnostics,
    SceneFlags,
    _cluster_lights,
    _default_lut,
    _rasterize_clip_peeled,
    _sampled,
    _up2,
    vis_alpha,
)
from transmission_renderer_tpu_torch.render.gbuffer import GBuffer, interpolate_gbuffer
from transmission_renderer_tpu_torch.render.raytrace import shadow_factors
from transmission_renderer_tpu_torch.render.shading import (
    ShadeContext,
    _dense_coords,
    build_material_matrix,
    cluster_light_mask,
    flatten_gbuffer,
    shade_opaque_flat,
    shade_transmission_flat,
)
from transmission_renderer_tpu_torch.utils.platform import CARD, f32_matmuls, resolve_device
from transmission_renderer_tpu_torch.utils.profiling import pass_scope


# ---------------------------------------------------------------------------
# the band group and its collectives
# ---------------------------------------------------------------------------

class BandMesh(NamedTuple):
    """One rank's view of the band group (the reference's one-axis Mesh)."""

    size: int  # bands (ranks)
    rank: int  # this rank's band
    device: torch.device  # where this rank's tensors live
    group: object | None  # the process group; None: a lone rank, no peers
    staged: bool  # collectives move CUDA tensors through host memory (gloo)


def make_band_mesh(n_devices: int | None = None, device=None) -> BandMesh:
    """The band group of this process: every rank of the initialised
    torch.distributed process group (``n_devices``, when given, must be
    its size), or without one a single band with no peers. ``device``
    defaults to the card, ``cuda:<rank % cards>``; pass ``"cpu"`` for a
    CPU group. NCCL groups need a card per rank; gloo groups take CPU or
    CUDA tensors (the latter staged through host memory)."""
    if dist.is_available() and dist.is_initialized():
        size, rank = dist.get_world_size(), dist.get_rank()
        group, backend = dist.group.WORLD, dist.get_backend()
    else:
        size, rank, group, backend = 1, 0, None, None
    if n_devices is not None and n_devices != size:
        raise ValueError(
            f"make_band_mesh({n_devices}): the process group has {size} rank(s); start "
            "one rank per band (torch.distributed.init_process_group, or "
            "parallel/ranks.py::BandRanks)")
    device = resolve_device(CARD if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    if backend == "nccl":
        if device.type != "cuda" or torch.cuda.device_count() < size:
            raise ValueError("an NCCL band group needs a card per rank; use gloo for ranks "
                             "that share a card or run on the CPU")
        torch.cuda.set_device(device)
    mesh = BandMesh(size, rank, device, group,
                    staged=backend == "gloo" and device.type == "cuda")
    if group is not None:
        # every rank takes part in the group's first collective (NCCL sets
        # up its communicator there)
        all_reduce_sum(mesh, torch.zeros((), dtype=torch.int32, device=device))
    return mesh


def _wire(mesh: BandMesh, t: torch.Tensor) -> torch.Tensor:
    """What a collective sends: a host copy under staging (the copy waits
    for the current stream), else the tensor itself."""
    return t.cpu() if mesh.staged else t.contiguous()


def _back(mesh: BandMesh, t: torch.Tensor) -> torch.Tensor:
    return t.to(mesh.device) if mesh.staged else t


def all_gather_rows(mesh: BandMesh, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every band's ``t`` joined along ``dim`` in band order (all_gather,
    tiled)."""
    if mesh.group is None:
        return t
    src = _wire(mesh, t)
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return _back(mesh, torch.cat(parts, dim=dim))


def exchange_rows(mesh: BandMesh, to_prev: torch.Tensor | None = None,
                  to_next: torch.Tensor | None = None) -> tuple:
    """The neighbour exchange (ppermute backward and forward): band i
    sends ``to_prev`` to band i - 1 and ``to_next`` to band i + 1
    -> (from the band before, from the band after), zeros where there is
    no such band (and None for a direction not asked for)."""
    from_prev = None if to_next is None else torch.zeros_like(to_next)
    from_next = None if to_prev is None else torch.zeros_like(to_prev)
    if mesh.group is None or mesh.size == 1:
        return from_prev, from_next
    r, last = mesh.rank, mesh.size - 1
    ops, bufs = [], {}

    def op(fn, t, peer):
        ops.append(dist.P2POp(fn, t, peer, mesh.group))

    if to_next is not None:
        if r < last:
            op(dist.isend, _wire(mesh, to_next), r + 1)
        if r > 0:
            bufs["prev"] = torch.empty_like(_wire(mesh, to_next))
            op(dist.irecv, bufs["prev"], r - 1)
    if to_prev is not None:
        if r > 0:
            op(dist.isend, _wire(mesh, to_prev), r - 1)
        if r < last:
            bufs["next"] = torch.empty_like(_wire(mesh, to_prev))
            op(dist.irecv, bufs["next"], r + 1)
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if "prev" in bufs:
        from_prev = _back(mesh, bufs["prev"])
    if "next" in bufs:
        from_next = _back(mesh, bufs["next"])
    return from_prev, from_next


def _all_reduce(mesh: BandMesh, t: torch.Tensor, op) -> torch.Tensor:
    if mesh.group is None:
        return t
    w = _wire(mesh, t).clone()
    dist.all_reduce(w, op=op, group=mesh.group)
    return _back(mesh, w)


def all_reduce_max(mesh: BandMesh, t: torch.Tensor) -> torch.Tensor:
    """Elementwise maximum over the bands (pmax)."""
    return _all_reduce(mesh, t, dist.ReduceOp.MAX)


def all_reduce_sum(mesh: BandMesh, t: torch.Tensor) -> torch.Tensor:
    """Elementwise sum over the bands (psum)."""
    return _all_reduce(mesh, t, dist.ReduceOp.SUM)


# ---------------------------------------------------------------------------
# the distributed pyramid
# ---------------------------------------------------------------------------

def _band_tile_rows(config: RenderConfig, n_bands: int) -> int:
    """Tile rows per band; tiles_y padded up to a multiple of n_bands
    (padded rows raster nothing visible and are cropped)."""
    return -(-config.tiles_y // n_bands)


def _trailing_zeros(n: int) -> int:
    return (n & -n).bit_length() - 1


class _BandPyramidSpec:
    """Static layout of the distributed pyramid (the reference's, without
    its quad-block offsets: levels stay planar).

    A level is band-local (its band slice and ``halo_px >> level`` rows
    from each neighbour) while the halo fits inside one neighbour band and
    the band height still halves evenly; the first level past those is
    gathered whole and the rest derived from it on every rank. Odd band
    heights gather level 0 (``l_local`` 0): halving each band on its own
    would drop a row at every band boundary."""

    def __init__(self, width: int, height: int, band_h: int, n_bands: int, halo_px: int):
        shapes = pyramid_shapes(width, height)  # the TRUE level sizes
        self.num_levels = len(shapes)
        self.widths = [s[0] for s in shapes]
        self.heights = [s[1] for s in shapes]
        max_aligned = min(_trailing_zeros(band_h), self.num_levels - 1)
        self.l_local = 0
        for level in range(max_aligned):
            if max(halo_px >> level, 1) >= (band_h >> level):
                break  # the halo would reach past the neighbour band
            self.l_local = level + 1
        self.band_rows = [band_h >> level for level in range(self.l_local)]
        self.halos = [max(halo_px >> level, 1) for level in range(self.l_local)]
        # rows each level keeps: a local level its haloed band slice, a
        # gathered level its true height
        self.slice_rows = [
            self.band_rows[level] + 2 * self.halos[level] if level < self.l_local
            else self.heights[level]
            for level in range(self.num_levels)
        ]


class BandPyramid(NamedTuple):
    """The band's pyramid: every level's kept rows as one [texels, 3]
    table (level k at ``offsets[k]``, row-major over its slice), and the
    per-level layout as int32 tensors indexed by level."""

    texels: torch.Tensor  # [N, 3] float32
    offsets: torch.Tensor  # [L] int64
    widths: torch.Tensor  # [L] int32
    heights: torch.Tensor  # [L] int32 true level heights
    slice_rows: torch.Tensor  # [L] int32
    band_rows: torch.Tensor  # [L] int32 (1 on gathered levels)
    halos: torch.Tensor  # [L] int32 (0 on gathered levels)
    local: torch.Tensor  # [L] bool


def _build_band_pyramid(hdr_band: torch.Tensor, spec: _BandPyramidSpec,
                        mesh: BandMesh) -> BandPyramid:
    """Band-local downsample chain, halo exchange, one coarse gather.
    ``hdr_band`` is the band's [3, band_h, W] opaque HDR. Edge bands get
    zeros in their unpaired halo; the sampler's clamp rules never read
    them."""
    fine = []
    cur = hdr_band
    for _ in range(spec.l_local):
        fine.append(cur)
        cur = _downsample2x(cur)
    # gather the first replicated level (small) and derive the rest
    coarse = [all_gather_rows(mesh, cur.contiguous(), dim=1)]
    for _ in range(spec.l_local + 1, spec.num_levels):
        coarse.append(_downsample2x(coarse[-1]))
    levels = []
    for level in range(spec.l_local):
        lvl = fine[level][:, :, : spec.widths[level]]
        r = spec.halos[level]
        # the halo from the band above is its bottom r rows, sent forward
        above, below = exchange_rows(mesh, to_prev=lvl[:, :r].contiguous(),
                                     to_next=lvl[:, -r:].contiguous())
        levels.append(torch.cat([above, lvl, below], dim=1))
    for i, lvl in enumerate(coarse):
        k = spec.l_local + i
        levels.append(lvl[:, : spec.heights[k], : spec.widths[k]])
    texels = torch.cat([lvl.permute(1, 2, 0).reshape(-1, 3) for lvl in levels])
    sizes = [lvl.shape[1] * lvl.shape[2] for lvl in levels]
    dev = hdr_band.device

    def ints(vals, dtype=torch.int32):
        return torch.tensor(vals, dtype=dtype, device=dev)

    n, nl = spec.num_levels, spec.l_local
    return BandPyramid(
        texels=texels,
        offsets=ints(np.concatenate([[0], np.cumsum(sizes)[:-1]]).tolist(), torch.int64),
        widths=ints(spec.widths),
        heights=ints(spec.heights),
        slice_rows=ints(spec.slice_rows),
        band_rows=ints(spec.band_rows + [1] * (n - nl)),
        halos=ints(spec.halos + [0] * (n - nl)),
        local=ints([True] * nl + [False] * (n - nl), torch.bool),
    )


def _sample_band_pyramid(pyr: BandPyramid, band: int, uv: torch.Tensor,
                         lod: torch.Tensor) -> torch.Tensor:
    """Trilinear clamp fetch from the distributed pyramid -> [..., 3]:
    exact within the halo, clamped to the halo's edge beyond it.

    The global clamp to the true level rows runs before the remap into
    the band's slice, so an edge band's zero halo is never addressed, and
    ``fy`` is 0 where the footprint's two rows were one source row (above
    the slice, or at the image's last row, below which the last band's
    slice goes on into padding): the lerp between equal rows is that
    single tap. The second row and column are clamped inside the slice."""
    max_level = pyr.widths.shape[0] - 1
    lod = torch.clamp(lod, 0.0, float(max_level))
    l0 = torch.floor(lod).to(torch.int64)
    l1 = torch.clamp(l0 + 1, max=max_level)

    def fetch(lvl):
        w, h, srows = pyr.widths[lvl], pyr.heights[lvl], pyr.slice_rows[lvl]
        x = uv[..., 0] * w.to(torch.float32) - 0.5
        y = uv[..., 1] * h.to(torch.float32) - 0.5
        x0f = torch.floor(x)
        y0f = torch.floor(y)
        fx = x - x0f
        fy = y - y0f
        x0 = x0f.to(torch.int32)
        y0 = y0f.to(torch.int32)
        fx = torch.where(x0 < 0, 0.0, fx)
        fy = torch.where(y0 < 0, 0.0, fy)
        x0 = torch.minimum(torch.clamp(x0, min=0), w - 1)
        y0g = torch.minimum(torch.clamp(y0, min=0), h - 1)
        y_raw = torch.where(pyr.local[lvl], y0g - (band * pyr.band_rows[lvl] - pyr.halos[lvl]),
                            y0g)
        fy = torch.where((y_raw < 0) | (y0g >= h - 1), 0.0, fy)
        y0s = torch.minimum(torch.clamp(y_raw, min=0), srows - 1)
        x1 = torch.minimum(x0 + 1, w - 1)
        y1s = torch.minimum(y0s + 1, srows - 1)
        base = pyr.offsets[lvl]
        w64 = w.to(torch.int64)

        def tap(yy, xx):
            return pyr.texels[base + yy.to(torch.int64) * w64 + xx.to(torch.int64)]

        c00, c10, c01, c11 = tap(y0s, x0), tap(y0s, x1), tap(y1s, x0), tap(y1s, x1)
        fx, fy = fx[..., None], fy[..., None]
        top = c00 + (c10 - c00) * fx
        bot = c01 + (c11 - c01) * fx
        return top + (bot - top) * fy

    c0 = fetch(l0)
    c1 = fetch(l1)
    frac = (lod - l0.to(torch.float32))[..., None]
    return c0 + (c1 - c0) * frac


# ---------------------------------------------------------------------------
# the sharded frame
# ---------------------------------------------------------------------------

def render_frame_sharded(
    scene,
    dl,
    params,
    lights,
    config: RenderConfig,
    mesh: BandMesh,
    ggx_lut: torch.Tensor | None = None,
    flags: SceneFlags | None = None,
    return_diagnostics: bool = False,
    bvh=None,
):
    """Sharded counterpart of render_frame: every rank of ``mesh`` calls
    it with the same inputs, on its device, and gets the whole tonemapped
    [H, W, 3] frame, plus the FrameDiagnostics reduced across bands with
    ``return_diagnostics``.

    Ray-traced shadows (``config.ray_traced_shadows`` and a ``bvh``) run
    band-locally: each rank refits the BVH and traces its own pixels'
    rays. The half-res form traces each band's half grid and upsamples
    with the band below's first half row; it needs an even band height
    too, and traces full-res rays (with a warning) otherwise."""
    f32_matmuls()
    use_rt = config.ray_traced_shadows and bvh is not None
    if config.ray_traced_shadows and bvh is None:
        raise ValueError(
            "config.ray_traced_shadows requires a BVH (SceneBuilder.build_rt_bvh())")
    if flags is None:
        flags = SceneFlags(has_alpha_clip=True, has_transmission=True)
    dev = scene.positions.device
    if ggx_lut is None:
        ggx_lut = _default_lut(config.ggx_lut_size, dev)

    n_bands, band = mesh.size, mesh.rank
    w, h = config.width, config.height
    tw, th = config.tile_w, config.tile_h
    tiles_x = config.tiles_x
    rows_per_band = _band_tile_rows(config, n_bands)
    band_h = rows_per_band * th
    tiles_y_padded = rows_per_band * n_bands
    use_pallas = config.use_pallas_raster
    if use_pallas is None:
        use_pallas = dev.type != "cpu" and (tw, th) == (TILE_W, TILE_H)
    if use_pallas and (tw, th) != (TILE_W, TILE_H):
        raise NotImplementedError(
            f"the G-buffer kernel with {th}x{tw} tiles: its tile is 8x128, as the "
            "reference kernel's")
    spec = _BandPyramidSpec(w, h, band_h, n_bands, config.sharded_refraction_halo_px)
    zero = torch.zeros((), dtype=torch.int32, device=dev)

    # ---- replicated prefix: vertex transform, cull, clusters -------------
    with pass_scope("geometry"):
        world_pos, world_nrm, uvs, clip, tri_scale = transform_vertices(
            scene, dl, params.proj_view)
        visible = cull_instances(scene, params.view, params.frustum_x_xz,
                                 params.frustum_y_yz, config.z_near)
        if use_rt:
            # per-frame refit on every rank, like the binning
            bvh = refit_bvh(bvh, dl.tri_vtx, world_pos)
    coeffs, counts, indices = _cluster_lights(config, params, lights, dev)
    ctx = ShadeContext(
        view_position=params.view_position,
        proj_view=params.proj_view,
        sun_dir=params.sun_dir,
        sun_intensity=params.sun_intensity,
        framebuffer_size=(w, h),
        cluster_size_in_pixels=config.cluster_size_in_pixels,
        num_clusters_xy=(config.num_clusters_x, config.num_clusters_y),
        cluster_coeffs=coeffs,
        cluster_light_counts=counts,
        cluster_light_indices=indices,
        lights=lights,
        ggx_lut=ggx_lut,
        tex_slots=flags.tex_slots,
        mat_matrix=build_material_matrix(scene, flags.tex_slots, flags.slot_bundles),
        debug_clusters=config.debug_clusters,
        bf16_lights=config.bf16_light_math,
        pallas_shade=use_pallas if config.pallas_shade is None else config.pallas_shade,
    )

    t0 = band * rows_per_band * tiles_x
    k_tiles = rows_per_band * tiles_x
    band_tiles = t0 + torch.arange(k_tiles, dtype=torch.int32, device=dev)
    row0_px = band * band_h
    px, py = _dense_coords(band_h, w, dev)
    py = py + row0_px

    def band_untile(a):
        return untile_image(a, tiles_x, rows_per_band, tw, th, w, band_h)

    # ---- band-local ray-traced shadows -----------------------------------
    use_half_rays = (use_rt and config.half_res_shadow_rays and band_h % 2 == 0
                     and w % 2 == 0 and h % 2 == 0)
    if use_rt and config.half_res_shadow_rays and not use_half_rays:
        warnings.warn(f"half_res_shadow_rays requires even band height and framebuffer "
                      f"dims; band_h={band_h} {w}x{h} traces FULL-res shadow rays",
                      stacklevel=2)

    def band_half_up_y(a):
        """Vertical 2x upsample of the band's half-res factors: odd rows
        average rows (i, i + 1), row band_h / 2 coming from the band
        below; from the image's last true half row on, the next row is
        that row (the single frame's edge clamp; the last band's padding
        never bleeds upward)."""
        bh2 = band_h // 2
        _, below = exchange_rows(mesh, to_prev=a[:1].contiguous())
        nxt = torch.cat([a[1:], below])
        glob = band * bh2 + torch.arange(bh2, device=a.device)
        need_clamp = (glob + 1 > (h // 2 - 1)).reshape((bh2,) + (1,) * (a.dim() - 1))
        last_local = min(max((h // 2 - 1) - band * bh2, 0), bh2 - 1)
        nxt = torch.where(need_clamp, a[last_local : last_local + 1], nxt)
        return _up2(a, 0, nxt_override=nxt)

    def band_shadow_factors(c: ShadeContext, g_band: GBuffer, pass_name: str) -> ShadeContext:
        """``c`` with the band's shadow factors over ``g_band``'s pixels."""
        with pass_scope(pass_name):
            if use_half_rays:
                # no cluster gating at half res (the upsample blends
                # factors across pixels)
                g_half = GBuffer(*(a[::2, ::2] for a in g_band))
                sun_h, light_h = shadow_factors(bvh, dl.tri_vtx, world_pos, g_half,
                                                params.sun_dir, lights)
                sun_f = _up2(band_half_up_y(sun_h), 1)
                light_f = _up2(band_half_up_y(light_h), 1)
            else:
                mask = (cluster_light_mask(c, g_band.depth.reshape(-1), px, py)
                        .reshape(band_h, w, lights.num) if lights.num else None)
                sun_f, light_f = shadow_factors(
                    bvh, dl.tri_vtx, world_pos, g_band, params.sun_dir, lights,
                    light_active=mask, packet_swizzle="2d")
        return c._replace(sun_shadow_factor=sun_f.reshape(-1),
                          light_shadow_factors=light_f.reshape(band_h * w, lights.num))

    # the band's single-row 128-px blocks (w % 128 == 0), with global rows
    if w % TILE_W:
        block_py = block_px0 = None
    else:
        bpr = w // TILE_W
        bid = torch.arange((band_h * w) // TILE_W, dtype=torch.int32, device=dev)
        block_py, block_px0 = row0_px + bid // bpr, (bid % bpr) * TILE_W

    diag = {"big": zero, "tier": zero, "clip_unresolved": zero, "bin": zero}

    # ---- band raster -> G-buffers ------------------------------------------
    if use_pallas:
        is_clip = (dl.tri_bucket == BUCKET_ALPHA_CLIP) | (
            dl.tri_bucket == BUCKET_TRANSMISSION_ALPHA_CLIP)
        tri_class = ((dl.tri_bucket == BUCKET_TRANSMISSION)
                     | (dl.tri_bucket == BUCKET_TRANSMISSION_ALPHA_CLIP)).to(torch.int32)
        tri_class = tri_class + 2 * is_clip.to(torch.int32)
        num_classes = 4 if flags.has_alpha_clip else 2
        n_tiles_global = tiles_x * tiles_y_padded
        with pass_scope("binning"):
            mask_all = bucket_triangle_masks(
                dl.tri_inst, dl.tri_bucket, visible,
                (BUCKET_OPAQUE, BUCKET_ALPHA_CLIP, BUCKET_TRANSMISSION,
                 BUCKET_TRANSMISSION_ALPHA_CLIP))
            setup = setup_triangles(clip, dl.tri_vtx, mask_all, w, h, tw, th)
            # the single frame's tier ladder (the reference's sharded frame
            # keeps a 512-slot mid list, which the 1080p flagship
            # overflows: ROADMAP, Faults); no pair-stream compaction, as
            # the reference's sharded frame passes no pair_cap_frac
            bins = bin_triangles(setup, tiles_x, tiles_y_padded, config.pallas_tiles_per_tri,
                                 tri_class, num_classes, config.pallas_tiers)
        diag["big"] = bins.big_tri_count.to(torch.int32)
        for demand, slots in zip(bins.tier_demands, bins.tier_slots):
            diag["tier"] = torch.maximum(diag["tier"], demand - slots)
        with pass_scope("payload"):
            records = pack_gbuf_payload(setup, dl.tri_vtx, dl.tri_material, tri_scale,
                                        world_pos, world_nrm, uvs, tri_class)
            payload = gather_gbuf_payload(records, bins)

        # one channel set for both passes (the union of their materials'
        # needs); the clip peel's alpha test reads the uv channels
        pos_derivs = flags.tex_slots[2] or flags.tex_slots_transmission[2]
        uv_channels = (_sampled(flags.tex_slots) or _sampled(flags.tex_slots_transmission)
                       or flags.has_alpha_clip)

        def band_channels(pass_class, tile_ids, init_tiles=None, max_depth_tiles=None):
            return rasterize_gbuffer_tiles(
                payload, tile_ids, bins.tile_start, 0, w, h, init_depth_tiles=init_tiles,
                max_depth_tiles=max_depth_tiles, pass_class=pass_class,
                pos_derivs=pos_derivs, uv_channels=uv_channels,
                n_tiles_global=n_tiles_global)

        def band_gbuffer(ch):
            return gbuffer_from_channels({n: band_untile(a) for n, a in ch.items()})

        def band_clip_peel(g_base, pass_class):
            """render_frame's depth peel over the band's tiles ->
            (merged G-buffer, unresolved pixels)."""
            with pass_scope("raster_clip_peel"):
                g, miss, _, _, _ = _rasterize_clip_peeled(
                    scene, payload, bins, 0, pass_class, g_base, config, w, h,
                    pos_derivs=pos_derivs, band=(t0, rows_per_band, n_tiles_global))
            return g, miss

        with pass_scope("raster_opaque"):
            g_o = band_gbuffer(band_channels(0, band_tiles))
        if flags.has_alpha_clip:
            g_o, miss = band_clip_peel(g_o, 2)
            diag["clip_unresolved"] = diag["clip_unresolved"] + miss
    else:
        alpha = vis_alpha(scene, dl, uvs) if flags.has_alpha_clip else None

        def raster_band(bucket_set, raster_pass, init_depth_tiles=None):
            with pass_scope("binning"):
                mask = bucket_triangle_masks(dl.tri_inst, dl.tri_bucket, visible, bucket_set)
                setup = setup_triangles(clip, dl.tri_vtx, mask, w, h, tw, th)
                bins = bin_triangles_materialized(
                    setup, tiles_x, tiles_y_padded, config.max_tiles_per_tri,
                    config.max_tris_per_tile, config.max_big_tris)
            diag["big"] = torch.maximum(diag["big"], bins.big_tri_count.to(torch.int32))
            diag["bin"] = torch.maximum(diag["bin"], bins.max_bin_count)
            with pass_scope(raster_pass):
                tri, depth, b1, b2 = rasterize_tilelist(
                    setup, bins, band_tiles, w, h, tw, th,
                    init_depth_tiles=init_depth_tiles, alpha=alpha)
                vis = VisibilityBuffer(tri_id=band_untile(tri), depth=band_untile(depth),
                                       bary=torch.stack([band_untile(b1), band_untile(b2)], -1))
                return interpolate_gbuffer(vis, setup, dl.tri_vtx, dl.tri_material, tri_scale,
                                           world_pos, world_nrm, uvs, w, h, row_offset=row0_px)

        g_o = raster_band((BUCKET_OPAQUE, BUCKET_ALPHA_CLIP), "raster_opaque")

    # ---- band shading --------------------------------------------------------
    ctx_o = band_shadow_factors(ctx, g_o, "shadow_rays_opaque") if use_rt else ctx
    with pass_scope("shade_opaque"):
        planes = shade_opaque_flat(scene, flatten_gbuffer(g_o), ctx_o, px, py,
                                   block_py, block_px0)
        hdr_planes = tuple(p.reshape(band_h, w) for p in planes)

    if flags.has_transmission:
        # ---- the distributed opaque pyramid -------------------------------
        with pass_scope("mip_pyramid"):
            pyramid = _build_band_pyramid(torch.stack(hdr_planes), spec, mesh)

        def fb_sampler(uv, lod):
            return _sample_band_pyramid(pyramid, band, uv, lod)

        init_tiles = tile_image(g_o.depth, tw, th).contiguous()
        if use_pallas:
            with pass_scope("raster_transmission"):
                g_t = band_gbuffer(band_channels(1, band_tiles, init_tiles=init_tiles))
            if flags.has_alpha_clip:
                g_t, miss_t = band_clip_peel(g_t, 3)
                diag["clip_unresolved"] = diag["clip_unresolved"] + miss_t
        else:
            g_t = raster_band((BUCKET_TRANSMISSION, BUCKET_TRANSMISSION_ALPHA_CLIP),
                              "raster_transmission", init_depth_tiles=init_tiles)
        ctx_t = ctx._replace(
            tex_slots=flags.tex_slots_transmission,
            mat_matrix=build_material_matrix(scene, flags.tex_slots_transmission,
                                             flags.slot_bundles),
        )
        # dense per band: a band-local block cap cannot be bounded by the
        # frame's coverage (one band may be all glass), and at a cap of
        # every block the worklist is the band
        if use_rt:
            ctx_t = band_shadow_factors(ctx_t, g_t, "shadow_rays_transmission")
        with pass_scope("shade_transmission"):
            hdr_t = shade_transmission_flat(
                scene, flatten_gbuffer(g_t), ctx_t, None, None, px, py, block_py, block_px0,
                fb_sampler=fb_sampler).reshape(band_h, w, 3)
            hdr_planes = tuple(torch.where(g_t.valid, hdr_t[..., c], hp)
                               for c, hp in enumerate(hdr_planes))

    with pass_scope("tonemap"):
        ldr_band = torch.stack(lottes_tonemap_planes(hdr_planes, bake_lottes_params()), -1)
        # capacities take the worst band (the binning is replicated, so the
        # maximum changes nothing there); unresolved pixels add up
        worst = all_reduce_max(mesh, torch.stack([diag["big"], diag["tier"], diag["bin"]]))
        unresolved = all_reduce_sum(mesh, diag["clip_unresolved"])
        ldr = all_gather_rows(mesh, ldr_band)[:h]
    if not return_diagnostics:
        return ldr
    return ldr, FrameDiagnostics(
        max_bin_count=worst[2],
        bin_capacity=0 if use_pallas else config.max_tris_per_tile,
        big_tri_count=worst[0],
        big_tri_capacity=config.pallas_tiers[-1][1] if use_pallas else config.max_big_tris,
        opaque_blocks=zero,
        opaque_block_capacity=0,
        transmission_blocks=zero,
        transmission_block_capacity=0,
        clip_unresolved=unresolved,
        mid_tri_count=zero,
        mid_tri_capacity=config.pallas_max_mid_tris if use_pallas else 0,
        tier_overflow=worst[1],
    )
