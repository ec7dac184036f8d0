// Visibility raster: one CUDA block per tile, one thread per pixel.
//
// Replaces the TPU kernel transmission_renderer_tpu/ops/raster_pallas.py
// ::_raster_kernel (pl.pallas_call at raster_pallas.py:332). Each block walks
// its tile's run of 16-float records (adjugate edge rows, clip z and w,
// tri id + class) and the big-triangle list, and races reversed-Z GREATER
// against the seeded depth; it writes the winner's triangle id, depth and
// two perspective-correct barycentrics.
//
// One template parameter picks the walk order, and with it which function
// of the reference the kernel equals:
//   XLA_ORDER = false: the Pallas kernel (raster_pallas.py:203-251): the big
//     list first, then the run; strict depth > best; b = e * (1 / esum).
//   XLA_ORDER = true: the pure raster (raster.py:518-600): the run (cut to
//     max_tris_per_tile by the caller's counts), then the big list;
//     depth > best, or equal with a smaller triangle id; b = e / esum.
// Tile size is a runtime argument (at most 1024 pixels).
//
// Bound: the record stream and the per-pixel edge tests. Every pixel of a
// tile evaluates every record of its run, so the block stages CHUNK records
// at a time through shared memory with coalesced loads and every thread
// reuses them. No atomics: records are walked in order and a tie keeps the
// first winner (or the smaller id), so triangle ids equal the plain version's.
//
// Arithmetic is the reference's as its CPU compiler contracts it: an edge
// function is fma(a, nx, b * ny) + c, and the clip w and z sums are
// fma(e2, v2, fma(e0, v0, e1 * v1)). The fmas are explicit (__fmaf_rn) and
// the library is built with --fmad=false, so nothing else contracts and the
// plain version (which rounds the same fmas through float64) gives the same
// bits; division and reciprocal are IEEE (no fast math).
#include "common.cuh"

namespace {

constexpr int REC_F32 = 16;
constexpr int CHUNK = 64;
constexpr int MAX_TILE_PX = 1024;
constexpr int CLASS_SHIFT = 22;
constexpr int CLASS_MASK = (1 << CLASS_SHIFT) - 1;

struct Best {
    int tri;
    float depth, b1, b2;
};

__device__ __forceinline__ bool covered(float e, float a, float b) {
    bool tl = (a > 0.0f) || ((a == 0.0f) && (b > 0.0f));
    return (e > 0.0f) || ((e == 0.0f) && tl);
}

template <bool XLA_ORDER>
__device__ __forceinline__ void race(const float* rec, float nx, float ny, int pass_class,
                                     Best& best) {
    const float a0 = rec[0], b0 = rec[1], c0 = rec[2];
    const float a1 = rec[3], b1 = rec[4], c1 = rec[5];
    const float a2 = rec[6], b2 = rec[7], c2 = rec[8];
    const float e0 = __fmaf_rn(a0, nx, b0 * ny) + c0;
    const float e1 = __fmaf_rn(a1, nx, b1 * ny) + c1;
    const float e2 = __fmaf_rn(a2, nx, b2 * ny) + c2;
    bool inside = covered(e0, a0, b0) && covered(e1, a1, b1) && covered(e2, a2, b2);
    const float w_int = __fmaf_rn(e2, rec[14], __fmaf_rn(e0, rec[12], e1 * rec[13]));
    const float z_int = __fmaf_rn(e2, rec[11], __fmaf_rn(e0, rec[9], e1 * rec[10]));
    const float depth = z_int / w_int;
    inside = inside && (w_int > 0.0f) && (depth >= 0.0f) && (depth <= 1.0f);
    const int tri_enc = (int)rec[15];
    if (pass_class >= 0)
        inside = inside && ((((tri_enc >> CLASS_SHIFT) & 1) == 1) == (pass_class == 1));
    if (!inside) return;
    const int tri = tri_enc < 0 ? tri_enc : (tri_enc & CLASS_MASK);
    const float esum = e0 + e1 + e2;
    if (XLA_ORDER) {
        if (!(depth > best.depth || (depth == best.depth && tri < best.tri))) return;
        best.b1 = e1 / esum;
        best.b2 = e2 / esum;
    } else {
        if (!(depth > best.depth)) return;
        const float inv = 1.0f / esum;
        best.b1 = e1 * inv;
        best.b2 = e2 * inv;
    }
    best.tri = tri;
    best.depth = depth;
}

// Walk records [start, start + count) of src, CHUNK at a time through shared
// memory; every thread of the block joins the loads and the barriers.
template <bool XLA_ORDER>
__device__ __forceinline__ void walk(const float* __restrict__ src, int start, int count,
                                     float (*chunk)[REC_F32], bool active, float nx,
                                     float ny, int pass_class, Best& best) {
    for (int base = 0; base < count; base += CHUNK) {
        const int n = min(CHUNK, count - base);
        __syncthreads();
        const float* from = src + (size_t)(start + base) * REC_F32;
        for (int i = threadIdx.x; i < n * REC_F32; i += blockDim.x)
            chunk[i / REC_F32][i % REC_F32] = from[i];
        __syncthreads();
        if (active)
            for (int r = 0; r < n; ++r) race<XLA_ORDER>(chunk[r], nx, ny, pass_class, best);
    }
}

template <bool XLA_ORDER>
__global__ void __launch_bounds__(MAX_TILE_PX)
raster_vis_kernel(const float* __restrict__ recs, const float* __restrict__ big,
                  const int* __restrict__ big_count, const int* __restrict__ tile_ids,
                  const int* __restrict__ run_start, const int* __restrict__ run_count,
                  const float* __restrict__ init_depth, int tiles_x, int tile_w, int tile_h,
                  float ndc_sx, float ndc_sy, int pass_class, int* __restrict__ tri_out,
                  float* __restrict__ depth_out, float* __restrict__ b1_out,
                  float* __restrict__ b2_out) {
    __shared__ float chunk[CHUNK][REC_F32];
    const int k = blockIdx.x;
    const int tile_px = tile_w * tile_h;
    const int lane = threadIdx.x;
    const bool active = lane < tile_px;
    const int row = lane / tile_w;
    const int col = lane % tile_w;
    const int tile = tile_ids[k];
    const int ty = tile / tiles_x;
    const int tx = tile % tiles_x;
    const float pxc = ((float)tx * (float)tile_w + (float)col) + 0.5f;
    const float pyc = ((float)ty * (float)tile_h + (float)row) + 0.5f;
    const float nx = pxc * ndc_sx - 1.0f;
    const float ny = pyc * ndc_sy - 1.0f;
    const size_t pix = (size_t)k * tile_px + lane;

    Best best{-1, (active && init_depth) ? init_depth[pix] : 0.0f, 0.0f, 0.0f};
    const int nbig = *big_count;
    const int start = run_start[k];
    const int count = run_count[k];
    if (XLA_ORDER) {
        walk<true>(recs, start, count, chunk, active, nx, ny, pass_class, best);
        walk<true>(big, 0, nbig, chunk, active, nx, ny, pass_class, best);
    } else {
        walk<false>(big, 0, nbig, chunk, active, nx, ny, pass_class, best);
        walk<false>(recs, start, count, chunk, active, nx, ny, pass_class, best);
    }
    if (active) {
        tri_out[pix] = best.tri;
        depth_out[pix] = best.depth;
        b1_out[pix] = best.b1;
        b2_out[pix] = best.b2;
    }
}

}  // namespace

TRT_EXPORT int trt_raster_vis(const float* recs, const float* big, const int* big_count,
                              const int* tile_ids, const int* run_start, const int* run_count,
                              const float* init_depth, int k_tiles, int tiles_x, int tile_w,
                              int tile_h, float ndc_sx, float ndc_sy, int pass_class,
                              int xla_order, int* tri_out, float* depth_out, float* b1_out,
                              float* b2_out, cudaStream_t stream) {
    const int tile_px = tile_w * tile_h;
    if (tile_px < 1 || tile_px > MAX_TILE_PX) return (int)cudaErrorInvalidValue;
    const int threads = (tile_px + 31) / 32 * 32;
    if (k_tiles > 0) {
        if (xla_order) {
            raster_vis_kernel<true><<<k_tiles, threads, 0, stream>>>(
                recs, big, big_count, tile_ids, run_start, run_count, init_depth, tiles_x,
                tile_w, tile_h, ndc_sx, ndc_sy, pass_class, tri_out, depth_out, b1_out,
                b2_out);
        } else {
            raster_vis_kernel<false><<<k_tiles, threads, 0, stream>>>(
                recs, big, big_count, tile_ids, run_start, run_count, init_depth, tiles_x,
                tile_w, tile_h, ndc_sx, ndc_sy, pass_class, tri_out, depth_out, b1_out,
                b2_out);
        }
    }
    return trt_launch_status();
}
