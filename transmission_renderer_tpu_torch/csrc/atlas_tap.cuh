// The atlas tap's device code, shared by kernel 2 (tap_finish.cu, the
// material taps) and the closest-hit walk (bvh_closest.cu, the caster's
// alpha test): one mip level's bilinear footprint in the bf16 quad-block
// atlas (scene/textures.py) and its lerp.
//
// The arithmetic is ops/texture.py's (_level_meta_from_rows,
// _wrap_bilinear_coords, _tap_footprint, _flat_row_index, _lerp4), term for
// term in IEEE float32 (the library is built with --fmad=false).
#pragma once

#include "common.cuh"

namespace trt {

constexpr int META_LAYERS_COL = 17;  // meta column of an image's layer count
constexpr int WRAP_REPEAT = 0;

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

// The layer class of a meta row: its layer count when the pool has that
// class (bit lc - 1 of class_mask), else the pool's lowest class.
__device__ __forceinline__ int layer_class(const int* row, int class_mask) {
    const int lp = row[META_LAYERS_COL];
    return (lp >= 1 && lp <= 31 && ((class_mask >> (lp - 1)) & 1)) ? lp : __ffs(class_mask);
}

}  // namespace trt
