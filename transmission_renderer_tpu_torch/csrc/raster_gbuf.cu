// G-buffer rasteriser: one CUDA block per 8x128 tile, one thread per pixel.
//
// Replaces the TPU kernel transmission_renderer_tpu/ops/raster_pallas_gbuf.py
// ::_kernel (pl.pallas_call at raster_pallas_gbuf.py:468). Each block walks
// its tile's run of class-split, depth-race-ordered records (64 f32 each:
// adjugate edge rows, clip z and w, tri id + class, three vertices of
// pos/nrm/uv, material, scale) and races reversed-Z GREATER against the
// seeded depth. The winner's attributes and their analytic screen-space
// derivatives are interpolated at win time and kept in registers; each
// active channel is written once at the end.
//
// Bound: the record stream. Every pixel of a tile evaluates every record
// of its run, so a block reads each record once into shared memory (a
// chunk of 32 records at a time) and 1024 threads reuse it. No atomics:
// records are walked in their sorted order and a tie keeps the first
// winner, so triangle ids equal the plain version's.
//
// Arithmetic is written in the reference's order, and the library is
// built with --fmad=false, so edge functions and depth round exactly as
// in the plain version (a contracted FMA would move coverage on shared
// edges).
#include "common.cuh"

namespace {

constexpr int TILE_H = 8;
constexpr int TILE_W = 128;
constexpr int TILE_PX = TILE_H * TILE_W;
constexpr int REC_F32 = 64;
constexpr int REC_USED = 42;  // [0:42] carry data, the rest is padding
constexpr int CHUNK = 32;
constexpr int CLASS_SHIFT = 22;
constexpr int CLASS_MASK = (1 << CLASS_SHIFT) - 1;

__device__ __forceinline__ bool covered(float e, float a, float b) {
    bool tl = (a > 0.0f) || ((a == 0.0f) && (b > 0.0f));
    return (e > 0.0f) || ((e == 0.0f) && tl);
}

__global__ void __launch_bounds__(TILE_PX)
raster_gbuf_kernel(const float* __restrict__ recs, const int* __restrict__ tile_start,
                   const int* __restrict__ tile_ids, const float* __restrict__ init_depth,
                   const float* __restrict__ max_depth, int tiles_x, int num_classes,
                   int pass_class, float ndc_sx, float ndc_sy, int pos_derivs,
                   int uv_channels, int n_fch, int k_tiles, int* __restrict__ tri_out,
                   int* __restrict__ mat_out, float* __restrict__ fout) {
    __shared__ float chunk[CHUNK][REC_USED];
    const int k = blockIdx.x;
    const int lane = threadIdx.x;
    const int row = lane / TILE_W;
    const int col = lane % TILE_W;
    const int tile = tile_ids[k];
    const int ty = tile / tiles_x;
    const int tx = tile % tiles_x;
    const float pxc = ((float)tx * (float)TILE_W + (float)col) + 0.5f;
    const float pyc = ((float)ty * (float)TILE_H + (float)row) + 0.5f;
    const float nx = pxc * ndc_sx - 1.0f;
    const float ny = pyc * ndc_sy - 1.0f;
    const size_t pix = (size_t)k * TILE_PX + lane;

    float best_depth = init_depth[pix];
    const float maxd = max_depth ? max_depth[pix] : __int_as_float(0x7f800000);
    int best_tri = -1, best_mat = 0;
    float best_scale = 1.0f;
    float attr[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 1.0f, 0.f, 0.f};  // pos, nrm, uv
    float dx[8] = {0.f}, dy[8] = {0.f};

    int start, end;
    if (pass_class < 0) {
        start = tile_start[num_classes * tile];
        end = tile_start[num_classes * tile + num_classes];
    } else {
        start = tile_start[num_classes * tile + pass_class];
        end = tile_start[num_classes * tile + pass_class + 1];
    }

    for (int base = start; base < end; base += CHUNK) {
        const int n = min(CHUNK, end - base);
        __syncthreads();
        for (int i = lane; i < n * REC_USED; i += TILE_PX) {
            const int r = i / REC_USED, c = i % REC_USED;
            chunk[r][c] = recs[(size_t)(base + r) * REC_F32 + c];
        }
        __syncthreads();
        for (int r = 0; r < n; ++r) {
            const float* rec = chunk[r];
            const float a0 = rec[0], b0 = rec[1], c0 = rec[2];
            const float a1 = rec[3], b1 = rec[4], c1 = rec[5];
            const float a2 = rec[6], b2 = rec[7], c2 = rec[8];
            const float e0 = a0 * nx + b0 * ny + c0;
            const float e1 = a1 * nx + b1 * ny + c1;
            const float e2 = a2 * nx + b2 * ny + c2;
            bool inside = covered(e0, a0, b0) && covered(e1, a1, b1) && covered(e2, a2, b2);
            const float w_int = e0 * rec[12] + e1 * rec[13] + e2 * rec[14];
            const float z_int = e0 * rec[9] + e1 * rec[10] + e2 * rec[11];
            const float depth = z_int / w_int;
            inside = inside && (w_int > 0.0f) && (depth >= 0.0f) && (depth <= 1.0f);
            const int tri_enc = (int)rec[15];
            if (pass_class >= 0) inside = inside && ((tri_enc >> CLASS_SHIFT) == pass_class);
            bool win = inside && (depth > best_depth) && (depth < maxd);
            if (!win) continue;

            const float d_sum = e0 + e1 + e2;
            const float inv_d = 1.0f / d_sum;
            const float a_sum = a0 + a1 + a2;
            const float b_sum = b0 + b1 + b2;
            const float inv_d2x = inv_d * inv_d * ndc_sx;
            const float inv_d2y = inv_d * inv_d * ndc_sy;
            for (int q = 0; q < 8; ++q) {
                const bool is_uv = q >= 6;
                if (is_uv && !uv_channels) continue;
                const float A0 = rec[16 + q], A1 = rec[24 + q], A2 = rec[32 + q];
                const float n_attr = e0 * A0 + e1 * A1 + e2 * A2;
                attr[q] = n_attr * inv_d;
                if (is_uv || (q < 3 && pos_derivs)) {
                    const float na = a0 * A0 + a1 * A1 + a2 * A2;
                    const float nb = b0 * A0 + b1 * A1 + b2 * A2;
                    dx[q] = (na * d_sum - n_attr * a_sum) * inv_d2x;
                    dy[q] = (nb * d_sum - n_attr * b_sum) * inv_d2y;
                }
            }
            best_tri = tri_enc < 0 ? tri_enc : (tri_enc & CLASS_MASK);
            best_mat = (int)rec[40];
            best_scale = rec[41];
            best_depth = depth;
        }
    }

    // float channel planes, in active_channels order minus tri/material
    const size_t plane = (size_t)k_tiles * TILE_PX;
    int ch = 0;
    fout[ch++ * plane + pix] = best_depth;
    for (int q = 0; q < 6; ++q) fout[ch++ * plane + pix] = attr[q];
    if (uv_channels) {
        fout[ch++ * plane + pix] = attr[6];
        fout[ch++ * plane + pix] = attr[7];
        fout[ch++ * plane + pix] = dx[6];
        fout[ch++ * plane + pix] = dx[7];
        fout[ch++ * plane + pix] = dy[6];
        fout[ch++ * plane + pix] = dy[7];
    }
    if (pos_derivs) {
        for (int q = 0; q < 3; ++q) fout[ch++ * plane + pix] = dx[q];
        for (int q = 0; q < 3; ++q) fout[ch++ * plane + pix] = dy[q];
    }
    fout[ch++ * plane + pix] = best_scale;
    (void)n_fch;
    tri_out[pix] = best_tri;
    mat_out[pix] = best_mat;
}

}  // namespace

TRT_EXPORT int trt_raster_gbuf(const float* recs, const int* tile_start, const int* tile_ids,
                               const float* init_depth, const float* max_depth, int k_tiles,
                               int tiles_x, int num_classes, int pass_class, float ndc_sx,
                               float ndc_sy, int pos_derivs, int uv_channels, int n_fch,
                               int* tri_out, int* mat_out, float* fout, cudaStream_t stream) {
    if (k_tiles > 0) {
        raster_gbuf_kernel<<<k_tiles, TILE_PX, 0, stream>>>(
            recs, tile_start, tile_ids, init_depth, max_depth, tiles_x, num_classes,
            pass_class, ndc_sx, ndc_sy, pos_derivs, uv_channels, n_fch, k_tiles, tri_out,
            mat_out, fout);
    }
    return trt_launch_status();
}
