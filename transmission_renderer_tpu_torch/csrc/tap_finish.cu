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
// lerp order is its _lerp4's. The trilinear tap is atlas_tap.cuh's,
// shared with kernel 6's alpha form (and its footprint with the
// closest-hit walk's alpha test).
#include "atlas_tap.cuh"

namespace {

using trt::Trilinear;

__global__ void tap_finish_kernel(const uint16_t* __restrict__ quads, int row_elems,
                                  const int* __restrict__ rows, int meta_stride,
                                  const float* __restrict__ uv, const float* __restrict__ lod_in,
                                  int m, int wrap, int class_mask, int l_max,
                                  float* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m) return;
    const int* row = rows + (size_t)i * meta_stride;
    const int lc = trt::layer_class(row, class_mask);
    const float u = uv[2 * (size_t)i], v = uv[2 * (size_t)i + 1];
    const Trilinear t = trt::trilinear_footprint(row, lod_in[i], u, v, wrap, row_elems, lc);
    const int stride = 4 * lc;  // texel stride inside a block
    for (int layer = 0; layer < l_max; ++layer) {
        for (int c = 0; c < 4; ++c) {
            const float val = layer < lc ? trt::trilinear_lerp(quads, t, stride, 4 * layer + c)
                                         : 0.0f;
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
