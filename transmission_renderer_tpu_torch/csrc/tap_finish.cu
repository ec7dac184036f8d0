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
// lerp order is its _lerp4's. The footprint and lerp are atlas_tap.cuh's,
// shared with the closest-hit walk's alpha test.
#include "atlas_tap.cuh"

namespace {

using trt::Footprint;
using trt::lerp4;
using trt::level_footprint;

__global__ void tap_finish_kernel(const uint16_t* __restrict__ quads, int row_elems,
                                  const int* __restrict__ rows, int meta_stride,
                                  const float* __restrict__ uv, const float* __restrict__ lod_in,
                                  int m, int wrap, int class_mask, int l_max,
                                  float* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m) return;
    const int* row = rows + (size_t)i * meta_stride;
    const int lc = trt::layer_class(row, class_mask);
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
