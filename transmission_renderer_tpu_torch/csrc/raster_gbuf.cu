// G-buffer rasteriser: a depth race over (tile, segment) work items, then
// a per-pixel resolve.
//
// Replaces the TPU kernel transmission_renderer_tpu/ops/raster_pallas_gbuf.py
// ::_kernel (pl.pallas_call at raster_pallas_gbuf.py:468). Per 8x128 tile
// it walks one list of records (64 f32 each: [0:9] adjugate edge rows,
// [9:12] clip z, [12:15] clip w, [15] tri id + class, [16:40] three
// vertices of pos/nrm/uv, [40] material, [41] scale): the big list (the
// big_count records every tile walks, as the reference's big_body does
// before the tile's run; none on class-split bins), then the tile's run of
// class-split, depth-race-ordered records. It races reversed-Z GREATER
// against the seeded depth (and below max_depth), and interpolates the
// winner's attributes and their analytic screen-space derivatives.
//
// What bounds it: the pixel-record tests (three edge functions, the w and
// z sums, a divide, 8 compares per pixel and record), and the run lengths
// are very uneven: the flagship's glass poles put ~5.5k records in one
// tile against a mean of ~70. Walking a tile's whole run in one block
// leaves the card waiting on its busiest tile. The design:
//
// - The winner is the record of maximum depth among those passing the
//   filters, ties to the smallest list position (the big list holds
//   positions [0, nbig), the run the rest). So a list is cut into
//   segments of at most `segment` records (ops/raster_gbuf.py::SEG), and
//   each (tile, segment) item is raced on its own. A block keeps per
//   pixel only the best (depth, list position) and merges it with one
//   64-bit atomicMax on the key (float bits of depth + 0 << 32) |
//   (2^32 - 1 - position): the + 0 turns -0 into +0, so the unsigned
//   order of the key is the depth order, ties to the smaller position. 0
//   means "no winner". The key buffer comes zeroed from the wrapper.
// - A persistent grid (as many 256-thread blocks as are resident) pulls
//   items from an atomic counter. The item list is compact and built on
//   the card by a one-block plan kernel (work_list.cuh, which kernel 6
//   shares): the tile slots with a non-empty
//   list, bucketed by segment count, most segments first (a counting sort;
//   runs of 63 segments and more share the top bucket), and the running
//   count of segments in that order. So the heaviest segments start in
//   the first wave, the host never waits to learn how many items there
//   are, and the host enqueues three kernels and no PyTorch glue (the
//   frame's host time is its bottleneck). A block finds its item's tile
//   by a binary search of that running count. The merge is a maximum, so
//   the order of slots within a bucket does not change the result.
// - The race reads 16 of a record's 64 floats (edge rows, z, w, id):
//   chunks of 32 records are staged into shared memory with 16-byte
//   cp.async copies, double-buffered so the next chunk loads while this
//   one is tested (the other resident blocks hide most of that latency
//   too: one 64-record chunk per item measured 1.5% faster). Each thread
//   tests one column of 4 pixels, so a record read from shared memory (a
//   broadcast) is used 4 times. A record covers few of a tile's 1024
//   pixels, so the depth (two sums and an IEEE divide) is computed only
//   where the edge functions cover: a warp's 128 pixels are usually all
//   outside and skip it together (31% off the race on the 1080p frame,
//   PERF.md, Findings).
// - The resolve runs one thread per pixel: it reads its winner's 42
//   floats once, recomputes the edge functions and depth with the race's
//   arithmetic, interpolates, and writes every channel coalesced. Pixels
//   without a winner get the seed depth, tri -1, material 0, nrm_z 1 and
//   scale 1.
//
// Arithmetic is written in the reference's order, and the library is
// built with --fmad=false, so edge functions and depth round exactly as
// in the plain version (a contracted FMA would move coverage on shared
// edges): the channels equal the plain version's bit for bit.
#include "work_list.cuh"

namespace {

constexpr int TILE_H = 8;
constexpr int TILE_W = 128;
constexpr int TILE_PX = TILE_H * TILE_W;
constexpr int REC_F32 = 64;
constexpr int RACE_F4 = 4;  // [0:16] of a record, as float4
constexpr int RES_F4 = 11;  // [0:44] of a record covers the 42 used floats
constexpr int CHUNK = 32;   // records per staged chunk: two per 64-record segment
constexpr int RACE_THREADS = 256;
constexpr int PX_PER_THREAD = TILE_PX / RACE_THREADS;  // one column, 4 rows
constexpr int RESOLVE_THREADS = 256;
constexpr int CLASS_SHIFT = 22;
constexpr int CLASS_MASK = (1 << CLASS_SHIFT) - 1;
constexpr unsigned int NO_INDEX = 0xFFFFFFFFu;

__device__ __forceinline__ bool covered(float e, float a, float b) {
    bool tl = (a > 0.0f) || ((a == 0.0f) && (b > 0.0f));
    return (e > 0.0f) || ((e == 0.0f) && tl);
}

// [start, end) of a tile's run in the sorted records: its class's run, or
// every class's (no class filter, or one-class bins)
__device__ __forceinline__ void tile_run(const int* __restrict__ tile_start, int tile,
                                         int num_classes, int pass_class, int& start,
                                         int& end) {
    if (pass_class < 0 || num_classes == 1) {
        start = tile_start[num_classes * tile];
        end = tile_start[num_classes * tile + num_classes];
    } else {
        start = tile_start[num_classes * tile + pass_class];
        end = tile_start[num_classes * tile + pass_class + 1];
    }
}

// Record v of a slot's list: the big list, then the run from `start`.
__device__ __forceinline__ const float* list_record(const float* recs, const float* big,
                                                    int nbig, int start, int v) {
    return v < nbig ? big + (size_t)v * REC_F32 : recs + (size_t)(start + v - nbig) * REC_F32;
}

// Stage list records [base, base + n) of a slot, the race's 16 floats of
// each, into one buffer.
__device__ __forceinline__ void stage_chunk(float4 (*buf)[RACE_F4], const float* recs,
                                            const float* big, int nbig, int start, int base,
                                            int n) {
    for (int i = threadIdx.x; i < n * RACE_F4; i += RACE_THREADS) {
        const int r = i / RACE_F4, part = i % RACE_F4;
        work_list::cp_async16(&buf[r][part],
                              list_record(recs, big, nbig, start, base + r) + part * 4);
    }
    work_list::cp_async_commit();
}

__device__ __forceinline__ int big_records(const int* big_count) {
    return big_count ? *big_count : 0;
}

// The segment count of slot k's list
struct ListSegments {
    const int* tile_start;
    const int* tile_ids;
    const int* big_count;
    int num_classes, pass_class, segment;
    __device__ __forceinline__ int operator()(int k) const {
        int start, end;
        tile_run(tile_start, tile_ids[k], num_classes, pass_class, start, end);
        return (big_records(big_count) + end - start + segment - 1) / segment;
    }
};

// The work list (work_list.cuh) over the slots' lists, on one block.
__global__ void __launch_bounds__(work_list::PLAN_THREADS)
raster_plan_kernel(const int* __restrict__ tile_start, const int* __restrict__ tile_ids,
                   const int* __restrict__ big_count, int k_tiles, int num_classes,
                   int pass_class, int segment, int* plan) {
    work_list::build(
        ListSegments{tile_start, tile_ids, big_count, num_classes, pass_class, segment},
        k_tiles, plan);
}

__global__ void __launch_bounds__(RACE_THREADS)
raster_race_kernel(const float* __restrict__ recs, const float* __restrict__ big,
                   const int* __restrict__ big_count, const int* __restrict__ tile_start,
                   const int* __restrict__ tile_ids, const float* __restrict__ init_depth,
                   const float* __restrict__ max_depth, int k_tiles, int tiles_x,
                   int num_classes, int pass_class, int segment, float ndc_sx, float ndc_sy,
                   unsigned long long* __restrict__ keys, int* plan) {
    __shared__ __align__(16) float4 stage[2][CHUNK][RACE_F4];
    // tile slot (-1: no items left), list begin, list end, run start
    __shared__ int item[4];
    const int col = threadIdx.x % TILE_W;
    const int row0 = (threadIdx.x / TILE_W) * PX_PER_THREAD;
    const int nbig = big_records(big_count);

    while (true) {
        if (threadIdx.x == 0) {
            int j;
            const int slot = work_list::pull(plan, k_tiles, j);
            int begin = 0, end = 0, start = 0;
            if (slot >= 0) {
                int stop;
                tile_run(tile_start, tile_ids[slot], num_classes, pass_class, start, stop);
                begin = j * segment;
                end = min(begin + segment, nbig + stop - start);
            }
            item[0] = slot;
            item[1] = begin;
            item[2] = end;
            item[3] = start;
        }
        __syncthreads();
        const int slot = item[0], begin = item[1], end = item[2], start = item[3];
        __syncthreads();  // item[] is rewritten by the next pull
        if (slot < 0) break;

        const int tile = tile_ids[slot];
        const float nx = (((float)(tile % tiles_x) * (float)TILE_W + (float)col) + 0.5f) *
                             ndc_sx - 1.0f;
        float ny[PX_PER_THREAD], best[PX_PER_THREAD], maxd[PX_PER_THREAD];
        int best_i[PX_PER_THREAD];
#pragma unroll
        for (int q = 0; q < PX_PER_THREAD; ++q) {
            const int row = row0 + q;
            const size_t pix = (size_t)slot * TILE_PX + row * TILE_W + col;
            ny[q] = (((float)(tile / tiles_x) * (float)TILE_H + (float)row) + 0.5f) * ndc_sy -
                    1.0f;
            best[q] = init_depth[pix];
            maxd[q] = max_depth ? max_depth[pix] : __int_as_float(0x7f800000);
            best_i[q] = -1;
        }

        const int n = end - begin;
        const int n_chunks = (n + CHUNK - 1) / CHUNK;
        stage_chunk(stage[0], recs, big, nbig, start, begin, min(CHUNK, n));
        for (int c = 0; c < n_chunks; ++c) {
            if (c + 1 < n_chunks) {
                stage_chunk(stage[(c + 1) & 1], recs, big, nbig, start, begin + (c + 1) * CHUNK,
                            min(CHUNK, n - (c + 1) * CHUNK));
                work_list::cp_async_wait<1>();
            } else {
                work_list::cp_async_wait<0>();
            }
            __syncthreads();
            const float4* buf = &stage[c & 1][0][0];
            const int m = min(CHUNK, n - c * CHUNK);
            for (int r = 0; r < m; ++r) {
                const float4 q0 = buf[r * RACE_F4], q1 = buf[r * RACE_F4 + 1];
                const float4 q2 = buf[r * RACE_F4 + 2], q3 = buf[r * RACE_F4 + 3];
                const float a0 = q0.x, b0 = q0.y, c0 = q0.z;
                const float a1 = q0.w, b1 = q1.x, c1 = q1.y;
                const float a2 = q1.z, b2 = q1.w, c2 = q2.x;
                const int tri_enc = (int)q3.w;
                // the class filter is the record's, so the branch is uniform
                if (pass_class >= 0 && (tri_enc >> CLASS_SHIFT) != pass_class) continue;
                const int idx = begin + c * CHUNK + r;
#pragma unroll
                for (int q = 0; q < PX_PER_THREAD; ++q) {
                    const float e0 = a0 * nx + b0 * ny[q] + c0;
                    const float e1 = a1 * nx + b1 * ny[q] + c1;
                    const float e2 = a2 * nx + b2 * ny[q] + c2;
                    // most records cover few of a tile's pixels: the depth
                    // (and its divide) only where the triangle covers
                    if (!(covered(e0, a0, b0) && covered(e1, a1, b1) && covered(e2, a2, b2)))
                        continue;
                    const float w_int = e0 * q3.x + e1 * q3.y + e2 * q3.z;
                    const float z_int = e0 * q2.y + e1 * q2.z + e2 * q2.w;
                    const float depth = z_int / w_int;
                    if ((w_int > 0.0f) && (depth >= 0.0f) && (depth <= 1.0f) &&
                        depth > best[q] && depth < maxd[q]) {
                        best[q] = depth;
                        best_i[q] = idx;
                    }
                }
            }
            __syncthreads();  // this buffer is refilled two chunks on
        }

#pragma unroll
        for (int q = 0; q < PX_PER_THREAD; ++q) {
            if (best_i[q] < 0) continue;
            const size_t pix = (size_t)slot * TILE_PX + (row0 + q) * TILE_W + col;
            const unsigned long long key =
                ((unsigned long long)__float_as_uint(best[q] + 0.0f) << 32) |
                (unsigned long long)(NO_INDEX - (unsigned int)best_i[q]);
            atomicMax(keys + pix, key);
        }
    }
}

__global__ void __launch_bounds__(RESOLVE_THREADS)
raster_resolve_kernel(const float* __restrict__ recs, const float* __restrict__ big,
                      const int* __restrict__ big_count, const int* __restrict__ tile_start,
                      const int* __restrict__ tile_ids, const float* __restrict__ init_depth,
                      const unsigned long long* __restrict__ keys, int k_tiles, int tiles_x,
                      int num_classes, int pass_class, float ndc_sx, float ndc_sy,
                      int pos_derivs, int uv_channels,
                      int* __restrict__ tri_out, int* __restrict__ mat_out,
                      float* __restrict__ fout) {
    const size_t plane = (size_t)k_tiles * TILE_PX;
    const size_t pix = (size_t)blockIdx.x * RESOLVE_THREADS + threadIdx.x;
    if (pix >= plane) return;
    const int k = (int)(pix / TILE_PX);
    const int lane = (int)(pix % TILE_PX);
    const int row = lane / TILE_W;
    const int col = lane % TILE_W;
    const int tile = tile_ids[k];
    const float pxc = ((float)(tile % tiles_x) * (float)TILE_W + (float)col) + 0.5f;
    const float pyc = ((float)(tile / tiles_x) * (float)TILE_H + (float)row) + 0.5f;
    const float nx = pxc * ndc_sx - 1.0f;
    const float ny = pyc * ndc_sy - 1.0f;

    float best_depth = init_depth[pix];
    int best_tri = -1, best_mat = 0;
    float best_scale = 1.0f;
    float attr[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 1.0f, 0.f, 0.f};  // pos, nrm, uv
    float dx[8] = {0.f}, dy[8] = {0.f};

    const unsigned long long key = keys[pix];
    if (key != 0ull) {
        const int v = (int)(NO_INDEX - (unsigned int)(key & 0xFFFFFFFFull));
        int start, stop;
        tile_run(tile_start, tile, num_classes, pass_class, start, stop);
        const float4* src = reinterpret_cast<const float4*>(
            list_record(recs, big, big_records(big_count), start, v));
        float rec[RES_F4 * 4];
#pragma unroll
        for (int i = 0; i < RES_F4; ++i) {
            const float4 v = __ldg(src + i);
            rec[4 * i] = v.x;
            rec[4 * i + 1] = v.y;
            rec[4 * i + 2] = v.z;
            rec[4 * i + 3] = v.w;
        }
        const float a0 = rec[0], b0 = rec[1], c0 = rec[2];
        const float a1 = rec[3], b1 = rec[4], c1 = rec[5];
        const float a2 = rec[6], b2 = rec[7], c2 = rec[8];
        const float e0 = a0 * nx + b0 * ny + c0;
        const float e1 = a1 * nx + b1 * ny + c1;
        const float e2 = a2 * nx + b2 * ny + c2;
        const float w_int = e0 * rec[12] + e1 * rec[13] + e2 * rec[14];
        const float z_int = e0 * rec[9] + e1 * rec[10] + e2 * rec[11];
        const float d_sum = e0 + e1 + e2;
        const float inv_d = 1.0f / d_sum;
        const float a_sum = a0 + a1 + a2;
        const float b_sum = b0 + b1 + b2;
        const float inv_d2x = inv_d * inv_d * ndc_sx;
        const float inv_d2y = inv_d * inv_d * ndc_sy;
#pragma unroll
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
        const int tri_enc = (int)rec[15];
        best_tri = tri_enc < 0 ? tri_enc : (tri_enc & CLASS_MASK);
        best_mat = (int)rec[40];
        best_scale = rec[41];
        best_depth = z_int / w_int;
    }

    // float channel planes, in active_channels order minus tri/material
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
    tri_out[pix] = best_tri;
    mat_out[pix] = best_mat;
}

}  // namespace

// big / big_count: the big list's records and the device int32 count of
// them (both null: no big list). keys: [k_tiles * 1025 + 1] zeroed 64-bit
// words: the per-pixel merge keys, then the plan (2 + 2 * k_tiles int32:
// the race's item counter, the slot count, the slot order, the running
// segment count).
TRT_EXPORT int trt_raster_gbuf(const float* recs, const float* big, const int* big_count,
                               const int* tile_start, const int* tile_ids,
                               const float* init_depth, const float* max_depth, int k_tiles,
                               int tiles_x, int num_classes, int pass_class, int segment,
                               float ndc_sx, float ndc_sy, int pos_derivs, int uv_channels,
                               unsigned long long* keys, int* tri_out, int* mat_out,
                               float* fout, cudaStream_t stream) {
    if (k_tiles > 0) {
        int* plan = reinterpret_cast<int*>(keys + (size_t)k_tiles * TILE_PX);
        raster_plan_kernel<<<1, work_list::PLAN_THREADS, 0, stream>>>(
            tile_start, tile_ids, big_count, k_tiles, num_classes, pass_class, segment, plan);
        int err = trt_launch_status();
        if (err != 0) return err;
        raster_race_kernel<<<trt_resident_blocks((const void*)raster_race_kernel,
                                                 RACE_THREADS),
                             RACE_THREADS, 0, stream>>>(
            recs, big, big_count, tile_start, tile_ids, init_depth, max_depth, k_tiles, tiles_x,
            num_classes, pass_class, segment, ndc_sx, ndc_sy, keys, plan);
        err = trt_launch_status();
        if (err != 0) return err;
        const size_t px = (size_t)k_tiles * TILE_PX;
        raster_resolve_kernel<<<(unsigned)((px + RESOLVE_THREADS - 1) / RESOLVE_THREADS),
                                RESOLVE_THREADS, 0, stream>>>(
            recs, big, big_count, tile_start, tile_ids, init_depth, keys, k_tiles, tiles_x,
            num_classes, pass_class, ndc_sx, ndc_sy, pos_derivs, uv_channels, tri_out, mat_out,
            fout);
    }
    return trt_launch_status();
}
