// Material tap: the whole trilinear atlas sampler, one thread per pixel.
//
// Replaces the TPU kernel transmission_renderer_tpu/ops/tap_finish.py
// ::_make_finish_kernel (pl.pallas_call at tap_finish.py:254). On the TPU
// the two level row-gathers stayed in XLA (Mosaic has no per-lane gather)
// and the kernel only finished the gathered bf16 rows; here each thread
// does the lod clamp, the level meta lookup, the footprint with REPEAT
// or CLAMP folding, both level fetches straight from the bf16 atlas, the
// sub-block select, the bf16 -> f32 convert, the bilinear lerp and the
// mip blend, and writes the 4 * Lmax bundle-channel planes. No gathered
// [M, row_elems] intermediate exists.
//
// Bound: memory latency of 2 scattered 16-texel block reads per pixel
// (8 B per layer-channel texel pair, mostly L2 hits for a coherent uv
// field). The plain version is ops/texture.py::sample_bundle_rows; the
// lerp order is its _lerp4's.
#include "common.cuh"

namespace {

constexpr int META_LAYERS_COL = 17;
constexpr int WRAP_REPEAT = 0;

__device__ __forceinline__ float bf16_to_f32(uint16_t bits) {
    return __uint_as_float(((uint32_t)bits) << 16);
}

struct Footprint {
    size_t base;  // element index of the block's first texel
    float fx, fy;
};

// One mip level's footprint for layer class lc (group geometry per class).
__device__ Footprint level_footprint(const int* row, int level, float u, float v,
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

__global__ void tap_finish_kernel(const uint16_t* __restrict__ quads, int row_elems,
                                  const int* __restrict__ rows, int meta_stride,
                                  const float* __restrict__ uv, const float* __restrict__ lod_in,
                                  int m, int wrap, int class_mask, int l_max,
                                  float* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m) return;
    const int* row = rows + (size_t)i * meta_stride;
    const int first = __ffs(class_mask);  // lowest class = the default
    const int lp = row[META_LAYERS_COL];
    const int lc = (lp >= 1 && lp <= 31 && ((class_mask >> (lp - 1)) & 1)) ? lp : first;
    float lod = lod_in[i];
    lod = lod < 0.0f ? 0.0f : lod;
    const float l0f = floorf(lod);
    const int l0 = (int)l0f;
    const float frac = lod - (float)l0;
    const float u = uv[2 * (size_t)i], v = uv[2 * (size_t)i + 1];
    const Footprint f0 = level_footprint(row, l0, u, v, wrap, row_elems, lc);
    const Footprint f1 = level_footprint(row, l0 + 1, u, v, wrap, row_elems, lc);
    const int stride = 4 * lc;  // texel stride inside a block
    for (int layer = 0; layer < l_max; ++layer) {
        for (int c = 0; c < 4; ++c) {
            float val = 0.0f;
            if (layer < lc) {
                const int ch = 4 * layer + c;
                const float v0 = lerp4(quads, f0.base, stride, ch, f0.fx, f0.fy);
                const float v1 = lerp4(quads, f1.base, stride, ch, f1.fx, f1.fy);
                val = v0 + (v1 - v0) * frac;
            }
            out[(size_t)(4 * layer + c) * m + i] = val;
        }
    }
}

}  // namespace

TRT_EXPORT int trt_tap_finish(const uint16_t* quads, int row_elems, const int* rows,
                              int meta_stride, const float* uv, const float* lod, int m,
                              int wrap, int class_mask, int l_max, float* out,
                              cudaStream_t stream) {
    if (m > 0) {
        const int threads = 256;
        tap_finish_kernel<<<(m + threads - 1) / threads, threads, 0, stream>>>(
            quads, row_elems, rows, meta_stride, uv, lod, m, wrap, class_mask, l_max, out);
    }
    return trt_launch_status();
}
