// Any-hit occlusion of shadow rays over the implicit 8-wide BVH: persistent
// warps, dynamic ray fetch, a while-while walk over a 16-byte-vector table.
//
// Replaces the TPU kernel transmission_renderer_tpu/ops/bvh_packet.py
// ::_make_kernel (pl.pallas_call at bvh_packet.py:397). The TPU walked
// 128-ray packets, 8 to a register tile, because a vector unit pays per
// packet pop and not per ray. Here each lane walks one ray with the
// reference's stackless bitstack walk (ops/bvh.py::trace_rays): the trail
// is two uint32 words in registers (one 8-bit child mask per tree level,
// codes 0-3 in the low word, 4-7 in the high one), and a node's ancestors
// follow from its index, so there is no stack in memory. A pop takes the
// lowest set bit of the lowest non-empty level (the deepest level's lowest
// untested child). An inner pop does 8 slab tests and pushes the mask of
// the children it hits; a leaf pop does up to 16 Moller-Trumbore tests and
// ends the ray at its first hit. Any-hit occlusion is an existence
// predicate, so the hit set is the same whatever order rays or children
// are visited in.
//
// What bounds it: the pops' tests (an inner pop is 8 slab tests of ~25
// operations, a leaf pop up to 16 triangle tests of ~55), each behind a
// load whose address depends on the previous pop, and lanes of one warp
// that want different work. The design (after Aila & Laine, "Understanding
// the Efficiency of Ray Traversal on GPUs", HPG 2009):
//
// - Persistent warps with dynamic fetch. As many warps as are resident
//   pull rays 32 at a time from a global counter, in the frame's
//   (swizzled, coherent) ray order. Dead rays (t_max <= t_min: invalid
//   pixels, cluster-gated lights) are written as misses at fetch time and
//   never take a lane. A warp refills its empty lanes when fewer than
//   REFILL_BELOW (8) lanes are live, so a warp no longer holds its slot
//   for its one longest ray (unoccluded sun rays walk to exhaustion,
//   occluded ones stop early); on the 1080p frame 16 and 24 measured 3%
//   and 9% slower than 8, and 4 the same (PERF.md, Findings).
// - While-while. Each lane pops inner nodes until it holds a leaf or its
//   trail is empty; the warp runs the leaf tests only once no lane wants
//   an inner pop, so the two bodies stop alternating inside a warp.
// - 16-byte loads. A node row is its 6 planes x 8 children (12 float4), a
//   triangle is v0, e1 = v1 - v0, e2 = v2 - v0 (3 float4); the edges are
//   the walk's own float32 subtractions, done once when the table is built
//   (ops/bvh_packet.py::kernel_walk_table), so every test rounds the same.
//   A triangle test returns as soon as its determinant, u or v fails.
// - The top levels stay in global memory: staging the node rows above
//   the deepest inner level (153 rows, 29 KB for the 134k-triangle
//   dragon) in shared memory once per block was measured 3% slower on the
//   1080p frame (PERF.md, Findings); the read-only cache holds them anyway.
//
// The arithmetic is bvh_packet.py:233-260 (triangles) and :287-309
// (slabs), term for term, in IEEE float32: the library is built with
// --fmad=false and without fast math, so products and sums round as in
// the plain version (ops/bvh.py::trace_occlusion_plain) and the hit sets
// are equal bit for bit.
#include "common.cuh"

namespace {

constexpr int LEAF_TRIS = 16;
constexpr int WIDE = 8;
constexpr int MAX_LEVELS = 7;
constexpr int NODE_F4 = 12;  // 6 planes x 8 children
constexpr int TRI_F4 = 3;    // v0, e1, e2
constexpr int THREADS = 128;
constexpr int REFILL_BELOW = 8;  // refill a warp's empty lanes below this many live ones
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Layout {
    int num_rows, num_leaves, num_tris, num_levels;
    int level_offsets[MAX_LEVELS];
    int children_below[MAX_LEVELS];
};

__device__ __forceinline__ bool ray_tri(const float4* __restrict__ p, float ox, float oy,
                                        float oz, float dx, float dy, float dz, float t_min,
                                        float t_max) {
    const float4 v0 = __ldg(p), e1 = __ldg(p + 1), e2 = __ldg(p + 2);
    const float pv0 = dy * e2.z - dz * e2.y;
    const float pv1 = dz * e2.x - dx * e2.z;
    const float pv2 = dx * e2.y - dy * e2.x;
    const float det = e1.x * pv0 + e1.y * pv1 + e1.z * pv2;
    if (!(fabsf(det) > 1e-12f)) return false;
    const float inv_det = 1.0f / det;
    const float tx = ox - v0.x, ty = oy - v0.y, tz = oz - v0.z;
    const float u = (tx * pv0 + ty * pv1 + tz * pv2) * inv_det;
    // u > 1 fails u + v <= 1 for every v >= 0 (adding v >= 0 cannot round
    // below u), so leaving here gives the same answer with less work
    if (!(u >= 0.0f && u <= 1.0f)) return false;
    const float qv0 = ty * e1.z - tz * e1.y;
    const float qv1 = tz * e1.x - tx * e1.z;
    const float qv2 = tx * e1.y - ty * e1.x;
    const float vv = (dx * qv0 + dy * qv1 + dz * qv2) * inv_det;
    if (!(vv >= 0.0f && u + vv <= 1.0f)) return false;
    const float t = (e2.x * qv0 + e2.y * qv1 + e2.z * qv2) * inv_det;
    return t > t_min && t < t_max;
}

// Slab tests of 4 children (planes as float4 lanes) -> 4-bit hit mask.
__device__ __forceinline__ uint32_t slab4(float4 x0, float4 y0, float4 z0, float4 x1, float4 y1,
                                          float4 z1, float ox, float oy, float oz, float ivx,
                                          float ivy, float ivz, float t_max) {
    const float b[6][4] = {{x0.x, x0.y, x0.z, x0.w}, {y0.x, y0.y, y0.z, y0.w},
                           {z0.x, z0.y, z0.z, z0.w}, {x1.x, x1.y, x1.z, x1.w},
                           {y1.x, y1.y, y1.z, y1.w}, {z1.x, z1.y, z1.z, z1.w}};
    uint32_t m = 0u;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        const float t00 = (b[0][c] - ox) * ivx, t10 = (b[3][c] - ox) * ivx;
        const float t01 = (b[1][c] - oy) * ivy, t11 = (b[4][c] - oy) * ivy;
        const float t02 = (b[2][c] - oz) * ivz, t12 = (b[5][c] - oz) * ivz;
        const float enter = fmaxf(fmaxf(fminf(t00, t10), fminf(t01, t11)), fminf(t02, t12));
        const float exit_ = fminf(fminf(fmaxf(t00, t10), fmaxf(t01, t11)), fmaxf(t02, t12));
        if (enter <= exit_ && exit_ >= 0.0f && enter <= t_max) m |= 1u << c;
    }
    return m;
}

__global__ void __launch_bounds__(THREADS)
bvh_occlusion_kernel(Layout lay, const float4* __restrict__ nodes,
                     const float4* __restrict__ tris, const float* __restrict__ rays, int n,
                     float t_min, int* __restrict__ next_ray, unsigned char* __restrict__ hit) {
    // per-level tables in shared memory: indexed by a run-time level, they
    // would otherwise be copied out of the parameter space onto the stack
    __shared__ int level_offsets[MAX_LEVELS], children_below[MAX_LEVELS];
    if (threadIdx.x == 0) {
#pragma unroll
        for (int k = 0; k < MAX_LEVELS; ++k) {
            level_offsets[k] = lay.level_offsets[k];
            children_below[k] = lay.children_below[k];
        }
    }
    __syncthreads();

    const size_t N = (size_t)n;
    const int lane = threadIdx.x & 31;
    const unsigned below = (1u << lane) - 1u;
    const int D = lay.num_levels;
    // virtual super-root: the real root (idx 0, code D) is the only set bit
    // of a new ray's trail, and its first pop descends into it
    const uint32_t root_mask = 1u << ((D & 3) * 8);

    int ray = -1;  // this lane's ray; -1: the lane is empty
    float ox = 0.f, oy = 0.f, oz = 0.f, ivx = 0.f, ivy = 0.f, ivz = 0.f;
    float dx = 0.f, dy = 0.f, dz = 0.f, t_max = 0.f;
    uint32_t tlo = 0u, thi = 0u;
    int lvl = 0, idx = 0;
    bool leaf = false;  // a popped leaf (idx) waits for its tests
    bool more = true;   // the counter has rays left (warp-uniform)

    while (true) {
        // ---- dynamic fetch: fill the empty lanes with live rays
        if (more && __popc(__ballot_sync(FULL, ray >= 0)) < REFILL_BELOW) {
            while (true) {
                const unsigned empty = __ballot_sync(FULL, ray < 0);
                if (empty == 0u) break;
                int base = 0;
                if (lane == 0) base = atomicAdd(next_ray, __popc(empty));
                base = __shfl_sync(FULL, base, 0);
                if (base >= n) {
                    more = false;
                    break;
                }
                if (ray < 0) {
                    const int r = base + __popc(empty & below);
                    if (r < n) {
                        const float tm = rays[9 * N + r];
                        if (tm > t_min) {
                            ray = r;
                            ox = rays[r];
                            oy = rays[N + r];
                            oz = rays[2 * N + r];
                            ivx = rays[3 * N + r];
                            ivy = rays[4 * N + r];
                            ivz = rays[5 * N + r];
                            dx = rays[6 * N + r];
                            dy = rays[7 * N + r];
                            dz = rays[8 * N + r];
                            t_max = tm;
                            tlo = D < 4 ? root_mask : 0u;
                            thi = D >= 4 ? root_mask : 0u;
                            lvl = D + 1;
                            idx = 0;
                        } else {
                            hit[r] = 0;  // dead: never pops
                        }
                    }
                }
            }
        }
        if (!__any_sync(FULL, ray >= 0)) break;  // no live ray and none left

        // ---- inner pops until every live lane holds a leaf
        while (true) {
            const bool want = ray >= 0 && !leaf;
            if (!__any_sync(FULL, want)) break;
            if (!want) continue;
            if (tlo == 0u && thi == 0u) {  // trail empty: a miss
                hit[ray] = 0;
                ray = -1;
                continue;
            }
            const bool have_lo = tlo != 0u;
            const uint32_t w = have_lo ? tlo : thi;
            const int pos = __ffs(w) - 1;  // lowest child of the deepest level
            if (have_lo) tlo ^= 1u << pos;
            else thi ^= 1u << pos;
            const int code = (pos >> 3) + (have_lo ? 0 : 4);
            const int sh = max(3 * (code + 1 - lvl), 0);
            idx = (idx >> sh) * WIDE + (pos & 7);
            lvl = code;
            if (lvl == 0) {
                leaf = true;
                continue;
            }
            // WIDE slab tests, push the mask of hit children
            const int clvl = lvl - 1;
            const int r = min(level_offsets[clvl] + idx, lay.num_rows - 1);
            const float4* row = nodes + (size_t)r * NODE_F4;
            const int n_child = max(min(WIDE, children_below[clvl] - idx * WIDE), 0);
            // planes p of children 0-3 at row[2p], of children 4-7 at row[2p + 1]
            uint32_t m8 = slab4(row[0], row[2], row[4], row[6], row[8], row[10], ox, oy, oz,
                                ivx, ivy, ivz, t_max);
            m8 |= slab4(row[1], row[3], row[5], row[7], row[9], row[11], ox, oy, oz, ivx, ivy,
                        ivz, t_max)
                  << 4;
            m8 &= (1u << n_child) - 1u;
            const uint32_t add = m8 << ((clvl & 3) * 8);
            if (clvl < 4) tlo |= add;
            else thi |= add;
        }

        // ---- leaf tests of every lane holding a leaf
        if (leaf) {
            leaf = false;
            const int li = min(idx, lay.num_leaves - 1);
            const float4* p = tris + (size_t)li * LEAF_TRIS * TRI_F4;
            const int n_tris = min(LEAF_TRIS, lay.num_tris - li * LEAF_TRIS);
            for (int t = 0; t < n_tris; ++t) {
                if (ray_tri(p + TRI_F4 * t, ox, oy, oz, dx, dy, dz, t_min, t_max)) {
                    hit[ray] = 1;
                    ray = -1;
                    break;
                }
            }
        }
    }
}

}  // namespace

// layout: num_rows, num_leaves, num_tris, num_levels, then MAX_LEVELS
// level offsets and MAX_LEVELS child counts. next_ray: one
// zeroed int, the fetch counter.
TRT_EXPORT int trt_bvh_occlusion(const int* layout, const float* nodes, const float* tris,
                                 const float* rays, int n, float t_min, int* next_ray,
                                 unsigned char* hit, cudaStream_t stream) {
    Layout lay;
    lay.num_rows = layout[0];
    lay.num_leaves = layout[1];
    lay.num_tris = layout[2];
    lay.num_levels = layout[3];
    for (int k = 0; k < MAX_LEVELS; ++k) {
        lay.level_offsets[k] = layout[4 + k];
        lay.children_below[k] = layout[4 + MAX_LEVELS + k];
    }
    if (n > 0) {
        bvh_occlusion_kernel<<<trt_resident_blocks((const void*)bvh_occlusion_kernel, THREADS),
                               THREADS, 0, stream>>>(
            lay, reinterpret_cast<const float4*>(nodes), reinterpret_cast<const float4*>(tris),
            rays, n, t_min, next_ray, hit);
    }
    return trt_launch_status();
}
