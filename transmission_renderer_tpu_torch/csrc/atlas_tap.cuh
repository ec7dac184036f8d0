// The atlas tap's device code, shared by kernel 2 (tap_finish.cu, the
// material taps), kernel 6's alpha form (raster_vis.cu, the in-raster
// alpha test), the peel's alpha test (clip_alpha.cu) and the closest-hit
// walk (bvh_closest.cu, the caster's alpha test): one mip level's bilinear
// footprint in the bf16 quad-block atlas (scene/textures.py) and its lerp,
// the two-level trilinear tap built from them, and the diffuse alpha test
// (diffuse_alpha_test) that kernel 6's alpha form and the peel's test
// share.
//
// The arithmetic is ops/texture.py's (_level_meta_from_rows,
// _wrap_bilinear_coords, _tap_footprint, _flat_row_index, _lerp4), term for
// term in IEEE float32 (the library is built with --fmad=false).
#pragma once

#include "common.cuh"

namespace trt {

constexpr int META_LAYERS_COL = 17;  // meta column of an image's layer count
constexpr int WRAP_REPEAT = 0;
constexpr int LAYER_SHIFT = 16;  // a packed texture ref: image | layer << LAYER_SHIFT
constexpr int IMAGE_MASK = (1 << LAYER_SHIFT) - 1;

__device__ __forceinline__ float bf16_to_f32(uint16_t bits) {
    return __uint_as_float(((uint32_t)bits) << 16);
}

struct Footprint {
    size_t base;  // element index of the block's first texel
    float fx, fy;
};

// One mip level's footprint for layer class lc (group geometry per class)
// from the image's meta row.
__device__ inline Footprint level_footprint(const int* row, int level, float u, float v,
                                            int wrap, int row_elems, int lc) {
    const int num_mips = row[0];
    level = min(max(level, 0), num_mips - 1);
    const int w = max(row[2] >> level, 1);
    const int h = max(row[3] >> level, 1);
    const int off = row[4 + level];
    const float x = u * (float)w - 0.5f;
    const float y = v * (float)h - 0.5f;
    const float x0f = floorf(x), y0f = floorf(y);
    float fx = x - x0f, fy = y - y0f;
    int x0 = (int)x0f, y0 = (int)y0f;
    if (wrap == WRAP_REPEAT) {
        x0 = ((x0 % w) + w) % w;
        y0 = ((y0 % h) + h) % h;
    } else {
        if (x0 < 0) fx = 0.0f;
        if (y0 < 0) fy = 0.0f;
        x0 = min(max(x0, 0), w - 1);
        y0 = min(max(y0, 0), h - 1);
    }
    const int bw = (w + 1) >> 1, bh = (h + 1) >> 1;
    const int phase = (y0 & 1) * 2 + (x0 & 1);
    const int qidx = off + phase * (bw * bh) + (y0 >> 1) * bw + (x0 >> 1);
    const int blkw = 16 * lc;
    int g = max(1, row_elems / blkw);
    int shift = 31 - __clz(g);  // floor(log2 g); the group is 1 << shift
    g = 1 << shift;
    const int r = qidx >> shift;
    const int sub = qidx & (g - 1);
    Footprint f;
    f.base = (size_t)r * row_elems + (size_t)sub * blkw;
    f.fx = fx;
    f.fy = fy;
    return f;
}

// Bilinear lerp of channel ch of a footprint's four texels (texel stride
// `stride` elements inside the block).
__device__ __forceinline__ float lerp4(const uint16_t* q, size_t base, int stride, int ch,
                                       float fx, float fy) {
    const float c00 = bf16_to_f32(q[base + 0 * stride + ch]);
    const float c10 = bf16_to_f32(q[base + 1 * stride + ch]);
    const float c01 = bf16_to_f32(q[base + 2 * stride + ch]);
    const float c11 = bf16_to_f32(q[base + 3 * stride + ch]);
    const float top = c00 + (c10 - c00) * fx;
    const float bot = c01 + (c11 - c01) * fx;
    return top + (bot - top) * fy;
}

// A trilinear tap's two mip levels: floor(lod) and the next, lod clamped
// at 0 (ops/texture.py::sample_bundle_rows).
struct Trilinear {
    Footprint f0, f1;
    float frac;
};

__device__ inline Trilinear trilinear_footprint(const int* row, float lod, float u, float v,
                                                int wrap, int row_elems, int lc) {
    lod = lod < 0.0f ? 0.0f : lod;
    const float l0f = floorf(lod);
    const int l0 = (int)l0f;
    Trilinear t;
    t.frac = lod - (float)l0;
    t.f0 = level_footprint(row, l0, u, v, wrap, row_elems, lc);
    t.f1 = level_footprint(row, l0 + 1, u, v, wrap, row_elems, lc);
    return t;
}

// Channel ch of a trilinear tap: the two levels' bilinear lerps, blended
// by the lod's fraction.
__device__ __forceinline__ float trilinear_lerp(const uint16_t* q, const Trilinear& t,
                                                int stride, int ch) {
    const float v0 = lerp4(q, t.f0.base, stride, ch, t.f0.fx, t.f0.fy);
    const float v1 = lerp4(q, t.f1.base, stride, ch, t.f1.fx, t.f1.fy);
    return v0 + (v1 - v0) * t.frac;
}

// The layer class of a meta row: its layer count when the pool has that
// class (bit lc - 1 of class_mask), else the pool's lowest class.
__device__ __forceinline__ int layer_class(const int* row, int class_mask) {
    const int lp = row[META_LAYERS_COL];
    return (lp >= 1 && lp <= 31 && ((class_mask >> (lp - 1)) & 1)) ? lp : __ffs(class_mask);
}

// torch.maximum: NaN if either is NaN
__device__ __forceinline__ float nan_max(float a, float b) {
    return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

// What the diffuse alpha test reads: per material its diffuse texture,
// alpha factor and cutoff, and the atlas.
struct AlphaMaterials {
    const int* tex_diffuse;     // [M] packed refs, -1: none
    const float* alpha_factor;  // diffuse_factor.a of material m at [m * factor_stride]
    const float* cutoff;        // [M] alpha_clipping_cutoff
    const uint16_t* quads;      // [R, row_elems] bf16 atlas
    const int* meta;            // [images, meta_stride]
    int factor_stride, n_images, meta_stride, row_elems, class_mask, l_max;
    long long n_texels;  // elements of the atlas
};

// What diffuse_alpha_test finds; the checked form's two faults read
// nothing past their bound.
enum AlphaResult : int { ALPHA_KILL = 0, ALPHA_KEEP = 1, ALPHA_BAD_IMAGE = 2, ALPHA_BAD_TEXEL = 3 };

// The alpha-clip test of material `mid` at one fragment (the fragment
// kill of the reference's depth_pre_pass_alpha_clip): the diffuse alpha,
// tapped trilinearly with REPEAT wrap at the implicit LOD of the uv's
// screen derivatives (render/shading.py::_mip_lod), times the material's
// factor (the factor alone without a texture), against its cutoff.
// uv_of(uv, dx, dy) fills the fragment's uv and its x and y derivatives;
// it is called only for a textured material. The layer rule is
// ops/texture.py::select_layer's: a layer past the atlas's largest class
// reads layer 0, and a layer the image lacks reads 0. CHECKED tests the
// image and the tap's texels against their bounds first.
template <bool CHECKED, class UvOf>
__device__ __forceinline__ int diffuse_alpha_test(const AlphaMaterials& a, int mid, UvOf uv_of) {
    const int tid = a.tex_diffuse[mid];
    float tap = 1.0f;
    if (tid >= 0) {
        const int img = tid & IMAGE_MASK;
        if (CHECKED && img >= a.n_images) return ALPHA_BAD_IMAGE;
        const int* row = a.meta + (size_t)img * a.meta_stride;
        float uv[2], dx[2], dy[2];
        uv_of(uv, dx, dy);
        const float tw = (float)row[2], th = (float)row[3];
        const float fx0 = dx[0] * tw, fx1 = dx[1] * th;
        const float fy0 = dy[0] * tw, fy1 = dy[1] * th;
        float rho = nan_max(fx0 * fx0 + fx1 * fx1, fy0 * fy0 + fy1 * fy1);
        rho = rho < 1e-12f ? 1e-12f : rho;  // torch.clamp: NaN stays NaN
        const float lod = 0.5f * log2f(rho);
        const int lc = layer_class(row, a.class_mask);
        int layer = tid >> LAYER_SHIFT;
        layer = layer < a.l_max ? layer : 0;  // a layer past the bundle reads layer 0
        if (layer < lc) {
            const Trilinear tr = trilinear_footprint(row, lod, uv[0], uv[1], WRAP_REPEAT,
                                                     a.row_elems, lc);
            const long long block = 16LL * lc;  // a 2x2 block of 4 * lc channels
            if (CHECKED && ((long long)tr.f0.base + block > a.n_texels ||
                            (long long)tr.f1.base + block > a.n_texels)) {
                return ALPHA_BAD_TEXEL;
            }
            tap = trilinear_lerp(a.quads, tr, 4 * lc, 4 * layer + 3);
        } else {
            tap = 0.0f;  // a layer the image lacks reads 0
        }
    }
    return a.alpha_factor[(size_t)mid * a.factor_stride] * tap >= a.cutoff[mid] ? ALPHA_KEEP
                                                                               : ALPHA_KILL;
}

}  // namespace trt
