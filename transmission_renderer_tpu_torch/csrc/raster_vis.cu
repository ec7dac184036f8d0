// Visibility raster: a depth race over (tile, segment) work items, then a
// per-pixel resolve.
//
// Replaces the TPU kernel transmission_renderer_tpu/ops/raster_pallas.py
// ::_raster_kernel (pl.pallas_call at raster_pallas.py:332). Each tile
// walks the big-triangle list and its run of 16-float records (adjugate
// edge rows, clip z and w, tri id + class) and races reversed-Z GREATER
// against the seeded depth; the winner's triangle id, depth and two
// perspective-correct barycentrics are written.
//
// One template parameter picks the walk order, and with it which function
// of the reference the kernel equals:
//   XLA_ORDER = false: the Pallas kernel (raster_pallas.py:203-251): the big
//     list first, then the run; strict depth > best; b = e * (1 / esum).
//     The winner is the first record walked of the greatest depth.
//   XLA_ORDER = true: the pure raster (raster.py:518-600): the run (cut to
//     max_tris_per_tile by the caller's counts), then the big list;
//     depth > best, or equal with a smaller triangle id; b = e / esum.
//     The winner is the record of the greatest (depth, -tri id).
// In both, only records strictly deeper than the seed win. Tile size is a
// runtime argument (at most 1024 pixels).
//
// What bounds it: the pixel-record tests, and the run lengths are very
// uneven (the 1080p frame's transmission pass holds 5,456 records in one
// tile uncut, 2,048 cut, against a mean of a few dozen). The design is
// kernel 1's (csrc/raster_gbuf.cu):
//
// - Each tile slot walks one list of nbig + count records: the big list
//   at positions [0, nbig), its run after it. A one-block plan kernel
//   (work_list.cuh) cuts the lists into segments of at most `segment`
//   records, the slots of most segments first, with no host sync.
// - A persistent grid of 256-thread blocks pulls (slot, segment) items
//   and stages the records, 32 at a time, with double-buffered 16-byte
//   cp.async copies. Each thread tests 4 pixels of the tile against each
//   record (a shared-memory broadcast); the depth, and its divide, only
//   where the three edge functions cover. It keeps the best per pixel by
//   the order's own rule and merges it with one 64-bit atomicMax on the
//   key (float bits of depth + 0 << 32) | (2^32 - 1 - id): + 0 folds -0
//   into +0, so the key orders as the float compare does; id is the list
//   position in kernel-6 order (the first walked wins a tie) and the
//   triangle id in XLA order (the smaller wins). 0 means no winner; the
//   key buffer comes zeroed from the wrapper.
// - The resolve runs one thread per pixel. It finds the winner's record
//   (kernel-6 order: by list position; XLA order: by triangle id in the
//   ungathered rows, which hold the same bits as any gathered copy),
//   recomputes its depth and barycentrics with the order's formula, and
//   writes tri, depth, b1, b2. Pixels without a winner get tri -1, the
//   seed depth (or 0) and b = 0.
// Padding records (tri id < 0, all-zero edges) cover nothing; the race
// skips them.
//
// Arithmetic is the reference's as its CPU compiler contracts it: an edge
// function is fma(a, nx, b * ny) + c, and the clip w and z sums are
// fma(e2, v2, fma(e0, v0, e1 * v1)). The fmas are explicit (__fmaf_rn) and
// the library is built with --fmad=false, so nothing else contracts and the
// plain version (which rounds the same fmas through float64) gives the same
// bits; division and reciprocal are IEEE (no fast math).
#include "work_list.cuh"

namespace {

constexpr int REC_F32 = 16;
constexpr int REC_F4 = REC_F32 / 4;
constexpr int CHUNK = 32;  // records per staged chunk: one per 32-record segment
constexpr int RACE_THREADS = 256;
constexpr int MAX_TILE_PX = 1024;
constexpr int PX_PER_THREAD = MAX_TILE_PX / RACE_THREADS;
constexpr int RESOLVE_THREADS = 256;
constexpr int CLASS_SHIFT = 22;
constexpr int CLASS_MASK = (1 << CLASS_SHIFT) - 1;
constexpr unsigned int NO_ID = 0xFFFFFFFFu;

__device__ __forceinline__ bool covered(float e, float a, float b) {
    bool tl = (a > 0.0f) || ((a == 0.0f) && (b > 0.0f));
    return (e > 0.0f) || ((e == 0.0f) && tl);
}

__device__ __forceinline__ float edge(float a, float b, float c, float nx, float ny) {
    return __fmaf_rn(a, nx, b * ny) + c;
}

// NDC centre of pixel `lane` of a tile, in the reference's order
__device__ __forceinline__ void pixel_ndc(int tile, int lane, int tiles_x, int tile_w,
                                          int tile_h, float ndc_sx, float ndc_sy, float& nx,
                                          float& ny) {
    const int row = lane / tile_w, col = lane % tile_w;
    nx = (((float)(tile % tiles_x) * (float)tile_w + (float)col) + 0.5f) * ndc_sx - 1.0f;
    ny = (((float)(tile / tiles_x) * (float)tile_h + (float)row) + 0.5f) * ndc_sy - 1.0f;
}

// Record v of a slot's list: the big list, then the run from `start`.
__device__ __forceinline__ const float* list_record(const float* recs, const float* big,
                                                    int nbig, int start, int v) {
    return v < nbig ? big + (size_t)v * REC_F32 : recs + (size_t)(start + v - nbig) * REC_F32;
}

// The segment count of slot k's list
struct ListSegments {
    const int* big_count;
    const int* run_count;
    int segment;
    __device__ __forceinline__ int operator()(int k) const {
        return (*big_count + run_count[k] + segment - 1) / segment;
    }
};

__global__ void __launch_bounds__(work_list::PLAN_THREADS)
raster_vis_plan(const int* __restrict__ big_count, const int* __restrict__ run_count,
                int k_tiles, int segment, int* plan) {
    work_list::build(ListSegments{big_count, run_count, segment}, k_tiles, plan);
}

// Stage list records [base, base + n) of a slot into one buffer.
__device__ __forceinline__ void stage_chunk(float4 (*buf)[REC_F4], const float* recs,
                                            const float* big, int nbig, int start, int base,
                                            int n) {
    for (int i = threadIdx.x; i < n * REC_F4; i += RACE_THREADS) {
        const int r = i / REC_F4, part = i % REC_F4;
        work_list::cp_async16(&buf[r][part],
                              list_record(recs, big, nbig, start, base + r) + part * 4);
    }
    work_list::cp_async_commit();
}

template <bool XLA_ORDER>
__global__ void __launch_bounds__(RACE_THREADS)
raster_vis_race(const float* __restrict__ recs, const float* __restrict__ big,
                const int* __restrict__ big_count, const int* __restrict__ tile_ids,
                const int* __restrict__ run_start, const int* __restrict__ run_count,
                const float* __restrict__ init_depth, int k_tiles, int tiles_x, int tile_w,
                int tile_h, float ndc_sx, float ndc_sy, int pass_class, int segment,
                unsigned long long* __restrict__ keys, int* plan) {
    __shared__ __align__(16) float4 stage[2][CHUNK][REC_F4];
    __shared__ int item[3];  // tile slot (-1: no items left), list begin, list end
    const int tile_px = tile_w * tile_h;
    const int nbig = *big_count;

    while (true) {
        if (threadIdx.x == 0) {
            int j;
            const int slot = work_list::pull(plan, k_tiles, j);
            item[0] = slot;
            item[1] = j * segment;
            item[2] = slot >= 0 ? min((j + 1) * segment, nbig + run_count[slot]) : 0;
        }
        __syncthreads();
        const int slot = item[0], begin = item[1], end = item[2];
        __syncthreads();  // item[] is rewritten by the next pull
        if (slot < 0) break;

        const int tile = tile_ids[slot];
        const int start = run_start[slot];
        float nx[PX_PER_THREAD], ny[PX_PER_THREAD], best[PX_PER_THREAD];
        int best_id[PX_PER_THREAD];  // list position or tri id; -1: none
#pragma unroll
        for (int q = 0; q < PX_PER_THREAD; ++q) {
            const int p = threadIdx.x + q * RACE_THREADS;
            pixel_ndc(tile, p, tiles_x, tile_w, tile_h, ndc_sx, ndc_sy, nx[q], ny[q]);
            // no record beats +inf: the pixels past a small tile's end
            best[q] = p >= tile_px ? __int_as_float(0x7f800000)
                      : init_depth ? init_depth[(size_t)slot * tile_px + p]
                                   : 0.0f;
            best_id[q] = -1;
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
                const float4 q0 = buf[r * REC_F4], q1 = buf[r * REC_F4 + 1];
                const float4 q2 = buf[r * REC_F4 + 2], q3 = buf[r * REC_F4 + 3];
                const int tri_enc = (int)q3.w;
                // padding and the class filter are the record's: uniform branches
                if (tri_enc < 0) continue;
                if (pass_class >= 0 &&
                    ((((tri_enc >> CLASS_SHIFT) & 1) == 1) != (pass_class == 1)))
                    continue;
                const int id = XLA_ORDER ? (tri_enc & CLASS_MASK) : begin + c * CHUNK + r;
                const float a0 = q0.x, b0 = q0.y, c0 = q0.z;
                const float a1 = q0.w, b1 = q1.x, c1 = q1.y;
                const float a2 = q1.z, b2 = q1.w, c2 = q2.x;
#pragma unroll
                for (int q = 0; q < PX_PER_THREAD; ++q) {
                    const float e0 = edge(a0, b0, c0, nx[q], ny[q]);
                    const float e1 = edge(a1, b1, c1, nx[q], ny[q]);
                    const float e2 = edge(a2, b2, c2, nx[q], ny[q]);
                    // most records cover few of a tile's pixels: the depth
                    // (and its divide) only where the triangle covers
                    if (!(covered(e0, a0, b0) && covered(e1, a1, b1) && covered(e2, a2, b2)))
                        continue;
                    const float w_int = __fmaf_rn(e2, q3.z, __fmaf_rn(e0, q3.x, e1 * q3.y));
                    const float z_int = __fmaf_rn(e2, q2.w, __fmaf_rn(e0, q2.y, e1 * q2.z));
                    const float depth = z_int / w_int;
                    if (!((w_int > 0.0f) && (depth >= 0.0f) && (depth <= 1.0f))) continue;
                    const bool wins =
                        XLA_ORDER ? (depth > best[q] || (depth == best[q] && id < best_id[q]))
                                  : depth > best[q];
                    if (wins) {
                        best[q] = depth;
                        best_id[q] = id;
                    }
                }
            }
            __syncthreads();  // this buffer is refilled two chunks on
        }

#pragma unroll
        for (int q = 0; q < PX_PER_THREAD; ++q) {
            if (best_id[q] < 0) continue;
            const size_t pix = (size_t)slot * tile_px + threadIdx.x + q * RACE_THREADS;
            const unsigned long long key =
                ((unsigned long long)__float_as_uint(best[q] + 0.0f) << 32) |
                (unsigned long long)(NO_ID - (unsigned int)best_id[q]);
            atomicMax(keys + pix, key);
        }
    }
}

template <bool XLA_ORDER>
__global__ void __launch_bounds__(RESOLVE_THREADS)
raster_vis_resolve(const float* __restrict__ recs, const float* __restrict__ big,
                   const float* __restrict__ rows, const int* __restrict__ big_count,
                   const int* __restrict__ tile_ids, const int* __restrict__ run_start,
                   const float* __restrict__ init_depth,
                   const unsigned long long* __restrict__ keys, int k_tiles, int tiles_x,
                   int tile_w, int tile_h, float ndc_sx, float ndc_sy, int* __restrict__ tri_out,
                   float* __restrict__ depth_out, float* __restrict__ b1_out,
                   float* __restrict__ b2_out) {
    const int tile_px = tile_w * tile_h;
    const size_t pix = (size_t)blockIdx.x * RESOLVE_THREADS + threadIdx.x;
    if (pix >= (size_t)k_tiles * tile_px) return;
    const int k = (int)(pix / tile_px);
    int tri = -1;
    float depth = init_depth ? init_depth[pix] : 0.0f, b1 = 0.0f, b2 = 0.0f;
    const unsigned long long key = keys[pix];
    if (key != 0ull) {
        const unsigned int id = NO_ID - (unsigned int)(key & 0xFFFFFFFFull);
        const float* src = XLA_ORDER
                               ? rows + (size_t)id * REC_F32
                               : list_record(recs, big, *big_count, run_start[k], (int)id);
        float rec[REC_F32];
#pragma unroll
        for (int i = 0; i < REC_F4; ++i) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(src) + i);
            rec[4 * i] = v.x;
            rec[4 * i + 1] = v.y;
            rec[4 * i + 2] = v.z;
            rec[4 * i + 3] = v.w;
        }
        float nx, ny;
        pixel_ndc(tile_ids[k], (int)(pix % tile_px), tiles_x, tile_w, tile_h, ndc_sx, ndc_sy,
                  nx, ny);
        const float e0 = edge(rec[0], rec[1], rec[2], nx, ny);
        const float e1 = edge(rec[3], rec[4], rec[5], nx, ny);
        const float e2 = edge(rec[6], rec[7], rec[8], nx, ny);
        const float w_int = __fmaf_rn(e2, rec[14], __fmaf_rn(e0, rec[12], e1 * rec[13]));
        const float z_int = __fmaf_rn(e2, rec[11], __fmaf_rn(e0, rec[9], e1 * rec[10]));
        depth = z_int / w_int;
        const float esum = e0 + e1 + e2;
        if (XLA_ORDER) {
            b1 = e1 / esum;
            b2 = e2 / esum;
        } else {
            const float inv = 1.0f / esum;
            b1 = e1 * inv;
            b2 = e2 * inv;
        }
        const int tri_enc = (int)rec[15];
        tri = tri_enc & CLASS_MASK;  // a winner is never padding
    }
    tri_out[pix] = tri;
    depth_out[pix] = depth;
    b1_out[pix] = b1;
    b2_out[pix] = b2;
}

template <bool XLA_ORDER>
int launch(const float* recs, const float* big, const float* rows, const int* big_count,
           const int* tile_ids, const int* run_start, const int* run_count,
           const float* init_depth, int k_tiles, int tiles_x, int tile_w, int tile_h,
           float ndc_sx, float ndc_sy, int pass_class, int segment, unsigned long long* keys,
           int* tri_out, float* depth_out, float* b1_out, float* b2_out, cudaStream_t stream) {
    const size_t px = (size_t)k_tiles * tile_w * tile_h;
    int* plan = reinterpret_cast<int*>(keys + px);
    raster_vis_plan<<<1, work_list::PLAN_THREADS, 0, stream>>>(big_count, run_count, k_tiles,
                                                                segment, plan);
    int err = trt_launch_status();
    if (err != 0) return err;
    raster_vis_race<XLA_ORDER>
        <<<trt_resident_blocks(reinterpret_cast<const void*>(&raster_vis_race<XLA_ORDER>),
                               RACE_THREADS),
           RACE_THREADS, 0, stream>>>(recs, big, big_count, tile_ids, run_start, run_count,
                                      init_depth, k_tiles, tiles_x, tile_w, tile_h, ndc_sx,
                                      ndc_sy, pass_class, segment, keys, plan);
    err = trt_launch_status();
    if (err != 0) return err;
    raster_vis_resolve<XLA_ORDER>
        <<<(unsigned)((px + RESOLVE_THREADS - 1) / RESOLVE_THREADS), RESOLVE_THREADS, 0,
           stream>>>(recs, big, rows, big_count, tile_ids, run_start, init_depth, keys,
                     k_tiles, tiles_x, tile_w, tile_h, ndc_sx, ndc_sy, tri_out, depth_out,
                     b1_out, b2_out);
    return trt_launch_status();
}

}  // namespace

// keys: [k_tiles * tile_w * tile_h + k_tiles + 1] zeroed 64-bit words: the
// per-pixel merge keys, then the plan (work_list.cuh: 2 + 2 * k_tiles
// int32). rows: the ungathered records by triangle id (XLA order's resolve).
TRT_EXPORT int trt_raster_vis(const float* recs, const float* big, const float* rows,
                              const int* big_count, const int* tile_ids, const int* run_start,
                              const int* run_count, const float* init_depth, int k_tiles,
                              int tiles_x, int tile_w, int tile_h, float ndc_sx, float ndc_sy,
                              int pass_class, int xla_order, int segment,
                              unsigned long long* keys, int* tri_out, float* depth_out,
                              float* b1_out, float* b2_out, cudaStream_t stream) {
    const int tile_px = tile_w * tile_h;
    if (tile_px < 1 || tile_px > MAX_TILE_PX || segment < 1) return (int)cudaErrorInvalidValue;
    if (k_tiles > 0) {
        return xla_order
                   ? launch<true>(recs, big, rows, big_count, tile_ids, run_start, run_count,
                                  init_depth, k_tiles, tiles_x, tile_w, tile_h, ndc_sx, ndc_sy,
                                  pass_class, segment, keys, tri_out, depth_out, b1_out, b2_out,
                                  stream)
                   : launch<false>(recs, big, rows, big_count, tile_ids, run_start, run_count,
                                   init_depth, k_tiles, tiles_x, tile_w, tile_h, ndc_sx, ndc_sy,
                                   pass_class, segment, keys, tri_out, depth_out, b1_out, b2_out,
                                   stream);
    }
    return trt_launch_status();
}
