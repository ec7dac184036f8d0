"""Renderer configuration and draw-bucket constants.

Counterpart of ``transmission_renderer_tpu/config.py``: the same
``RenderConfig`` dataclass (every field, default and property) and the
same ``BUCKET_*`` constants, kept as the port's own copy so that the port
imports nothing of the JAX package. The comments are shortened; the
reference's file explains each knob at length.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # --- framebuffer -------------------------------------------------------
    width: int = 1920
    height: int = 1080

    # --- projection (reference src/main.rs:39-57) --------------------------
    z_near: float = 0.01
    z_far: float = 500.0
    vertical_fov: float = math.radians(59.0)

    # --- clustered lighting grid (reference src/main.rs:60-63) -------------
    num_clusters_x: int = 24
    num_clusters_y: int = 16
    num_depth_slices: int = 16
    # reference shared-structs/src/lib.rs:322
    max_lights_per_cluster: int = 128

    # --- CLI-equivalent knobs (reference src/main.rs:65-91) ----------------
    ray_traced_shadows: bool = False
    spotlights: bool = False
    rotate_model: bool = False
    debug_clusters: bool = False

    # --- raster tiling ------------------------------------------------------
    tile_h: int = 8
    tile_w: int = 128
    # per-tile bin capacity of the pure raster path; triangles covering
    # more than max_tiles_per_tri tiles go to the capped big-triangle list
    max_tris_per_tile: int = 2048
    max_tiles_per_tri: int = 16
    max_big_tris: int = 256

    # --- G-buffer-kernel binning tiers (ops/raster.py::bin_triangles) ------
    pallas_tiles_per_tri: int = 2
    pallas_mid_tile_cap: int = 128
    pallas_max_mid_tris: int = 512
    pallas_max_big_tris: int = 32
    # (tile_cap, max_tris) rungs of the demotion ladder; cap 0 is the
    # full-screen catch-all. Rung overflow drops draws and shows in
    # FrameDiagnostics.tier_overflow.
    pallas_tiers: tuple = ((8, 4096), (128, 512), (2048, 64), (0, 16))
    # pair-stream compaction before the kernel branch's binning sort
    # (ops/raster.py::bin_triangles; None = off; the row-band sharded
    # frame ignores it, as the reference's does)
    pallas_pair_cap_frac: float | None = None

    # rasteriser backend: None = auto, True/False force the G-buffer
    # kernel / the pure raster path
    use_pallas_raster: bool | None = None
    # the reference's interpreter mode for its TPU kernels (no meaning in
    # the port, kept for configuration parity)
    pallas_interpret: bool = False
    # the fused deferred-shade kernel (None = auto)
    pallas_shade: bool | None = None
    static_raster_trips: bool = False
    # quality flags, all off by default for exact per-pixel results
    half_res_refraction: bool = False
    quad_material_taps: bool = False
    # trace the opaque pass's shadow rays on the half-res pixel grid and
    # upsample the visibility factors (the transmission pass stays full-res)
    half_res_shadow_rays: bool = False
    # skip shadow rays for (pixel, light) pairs with G-buffer N.L <= 0 in
    # the opaque pass of normal-map-free scenes; NOT exact (see the
    # reference's tests/test_rt_shadows.py::test_nol_gate_error_bound)
    nol_shadow_gate: bool = False

    # --- block-sparse shading (render/sparse.py) ----------------------------
    # worklist caps as a fraction of the 128-px blocks; None = dense.
    # Overflow leaves blocks unshaded and shows in FrameDiagnostics.
    opaque_block_cap_frac: float | None = None
    transmission_block_cap_frac: float | None = 0.25

    # --- sparse-tile raster passes (render/frame.py) -------------------------
    # tile worklist caps as a fraction of the tile grid, with a floor;
    # None = dense (every tile)
    transmission_tile_cap_frac: float | None = 0.25
    clip_tile_cap_frac: float | None = 0.5
    sparse_raster_tile_floor: int = 256

    # --- alpha-clip depth peeling (render/frame.py) --------------------------
    alpha_clip_rounds: int = 4
    clip_retile_cap_frac: float | tuple = (0.30, 0.08, 0.02)

    # --- multi-chip -----------------------------------------------------------
    sharded_refraction_halo_px: int = 64

    # --- GGX split-sum LUT -------------------------------------------------
    # sampled size of the LUT (utils/ggx_lut.py); None = native resolution
    ggx_lut_size: int | None = 256

    # --- precision ---------------------------------------------------------
    dtype: str = "float32"
    bf16_light_math: bool = False

    @property
    def num_clusters(self) -> int:
        return self.num_clusters_x * self.num_clusters_y * self.num_depth_slices

    @property
    def framebuffer_size(self) -> tuple[int, int]:
        return (self.width, self.height)

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile_w)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile_h)

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def cluster_size_in_pixels(self) -> tuple[float, float]:
        # reference src/main.rs:540-542
        return (
            self.width / self.num_clusters_x,
            self.height / self.num_clusters_y,
        )


# Bindless image table capacity (reference src/main.rs:59); only a default
# metadata-table size for the flat texel atlas.
MAX_IMAGES = 193

# Draw-bucket indices (reference src/model_loading.rs:68-78).
BUCKET_OPAQUE = 0
BUCKET_ALPHA_CLIP = 1
BUCKET_TRANSMISSION = 2
BUCKET_TRANSMISSION_ALPHA_CLIP = 3
NUM_DRAW_BUCKETS = 4
