// Transmission fetch: refraction taps into the opaque HDR mip pyramid plus
// the GGX split-sum LUT tap, one thread per pixel.
//
// Replaces the TPU kernel transmission_renderer_tpu/ops/tap_finish.py
// ::_transmission_fetch_kernel (pl.pallas_call at tap_finish.py:380). The
// TPU kernel consumed quad-block rows gathered by XLA; here each thread
// reads the pyramid levels (planar float32 [3, h, w] each) and the LUT
// ([S, S, 2]) directly: the lod is clamped into the static level set, the
// two bracketing levels get tent weights (the second is 0 at the set's
// top), each level is a clamp-to-edge bilinear tap, and the LUT is one
// clamped bilinear tap at (NoV, roughness). Outputs are 5 planes:
// transmitted r, g, b and the LUT's (a, b).
//
// Reading levels directly also covers the ROW-form level 0 that the
// reference's fetch-parts path refuses (mipchain.py:583-584); the
// reference reaches the same values through XLA there.
//
// Bound: scattered 12-byte texel reads (8 per pixel) from small, L2-
// resident levels. The plain version is ops/mipchain.py::
// sample_pyramid_lod + ops/texture.py::sample_lut_2ch, term for term.
#include "common.cuh"

namespace {

constexpr int MAX_LEVELS = 16;

struct Levels {
    const float* p[MAX_LEVELS];
    int w[MAX_LEVELS];
    int h[MAX_LEVELS];
};

__device__ __forceinline__ void bilinear_clamp(const float* lvl, int w, int h, float u,
                                               float v, float out[3]) {
    const float x = u * (float)w - 0.5f;
    const float y = v * (float)h - 0.5f;
    const float x0f = floorf(x), y0f = floorf(y);
    float fx = x - x0f, fy = y - y0f;
    int x0 = (int)x0f, y0 = (int)y0f;
    if (x0 < 0) fx = 0.0f;
    if (y0 < 0) fy = 0.0f;
    x0 = min(max(x0, 0), w - 1);
    y0 = min(max(y0, 0), h - 1);
    const int x1 = min(x0 + 1, w - 1);
    const int y1 = min(y0 + 1, h - 1);
    const size_t plane = (size_t)w * h;
    for (int c = 0; c < 3; ++c) {
        const float* p = lvl + c * plane;
        const float c00 = p[(size_t)y0 * w + x0];
        const float c10 = p[(size_t)y0 * w + x1];
        const float c01 = p[(size_t)y1 * w + x0];
        const float c11 = p[(size_t)y1 * w + x1];
        const float top = c00 + (c10 - c00) * fx;
        const float bot = c01 + (c11 - c01) * fx;
        out[c] = top + (bot - top) * fy;
    }
}

__global__ void transmission_fetch_kernel(Levels lv, int lo, int hi,
                                          const float* __restrict__ uv_x,
                                          const float* __restrict__ uv_y,
                                          const float* __restrict__ lod_in,
                                          const float* __restrict__ nov,
                                          const float* __restrict__ rough, int m,
                                          const float* __restrict__ lut, int lut_size,
                                          float* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m) return;
    const float u = uv_x[i], v = uv_y[i];
    float lod = lod_in[i];
    lod = fminf(fmaxf(lod, (float)lo), (float)hi);
    const float l0f = floorf(lod);
    const int l0 = min(max((int)l0f, lo), hi);
    const int l1 = min(l0 + 1, hi);
    const float w0 = fminf(fmaxf(1.0f - fabsf(lod - l0f), 0.0f), 1.0f);
    float w1 = fminf(fmaxf(1.0f - fabsf(lod - (l0f + 1.0f)), 0.0f), 1.0f);
    if (l1 == l0) w1 = 0.0f;
    float c0[3], c1[3];
    bilinear_clamp(lv.p[l0 - lo], lv.w[l0 - lo], lv.h[l0 - lo], u, v, c0);
    bilinear_clamp(lv.p[l1 - lo], lv.w[l1 - lo], lv.h[l1 - lo], u, v, c1);
    for (int c = 0; c < 3; ++c) out[(size_t)c * m + i] = c0[c] * w0 + c1[c] * w1;

    // GGX LUT: clamp-sampled bilinear at (NoV, roughness)
    const float s = (float)lut_size;
    const float x = fminf(fmaxf(nov[i] * s - 0.5f, 0.0f), s - 1.0f);
    const float y = fminf(fmaxf(rough[i] * s - 0.5f, 0.0f), s - 1.0f);
    const float x0f = floorf(x), y0f = floorf(y);
    const int x0 = min(max((int)x0f, 0), lut_size - 1);
    const int y0 = min(max((int)y0f, 0), lut_size - 1);
    const float fx = x - (float)x0, fy = y - (float)y0;
    const int x1 = min(x0 + 1, lut_size - 1), y1 = min(y0 + 1, lut_size - 1);
    for (int c = 0; c < 2; ++c) {
        const float c00 = lut[((size_t)y0 * lut_size + x0) * 2 + c];
        const float c10 = lut[((size_t)y0 * lut_size + x1) * 2 + c];
        const float c01 = lut[((size_t)y1 * lut_size + x0) * 2 + c];
        const float c11 = lut[((size_t)y1 * lut_size + x1) * 2 + c];
        const float top = c00 + (c10 - c00) * fx;
        const float bot = c01 + (c11 - c01) * fx;
        out[(size_t)(3 + c) * m + i] = top + (bot - top) * fy;
    }
}

}  // namespace

TRT_EXPORT int trt_transmission_fetch(const float* const* level_ptrs, const int* widths,
                                      const int* heights, int lo, int hi, const float* uv_x,
                                      const float* uv_y, const float* lod, const float* nov,
                                      const float* rough, int m, const float* lut,
                                      int lut_size, float* out, cudaStream_t stream) {
    if (hi - lo + 1 > MAX_LEVELS || hi < lo) return (int)cudaErrorInvalidValue;
    Levels lv = {};
    for (int k = 0; k <= hi - lo; ++k) {
        lv.p[k] = level_ptrs[k];
        lv.w[k] = widths[k];
        lv.h[k] = heights[k];
    }
    if (m > 0) {
        const int threads = 256;
        transmission_fetch_kernel<<<(m + threads - 1) / threads, threads, 0, stream>>>(
            lv, lo, hi, uv_x, uv_y, lod, nov, rough, m, lut, lut_size, out);
    }
    return trt_launch_status();
}
