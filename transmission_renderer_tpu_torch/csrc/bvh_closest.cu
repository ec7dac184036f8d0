// Closest-hit, alpha-tested walk of camera rays over the implicit 8-wide
// BVH (the AS-debug caster): persistent warps, dynamic ray fetch, a
// while-while walk over kernel 5's 16-byte-vector table.
//
// No TPU kernel is replaced: on the TPU the caster's walk is one fused XLA
// while_loop program (transmission_renderer_tpu/ops/bvh.py::trace_rays at
// :331, any_hit=False with alpha_test_fn, called from
// render/raytrace.py::as_debug_view). In eager PyTorch that walk is a loop
// of small ops per pop (ops/bvh.py::trace_closest_plain, this kernel's
// plain version), so on the card it runs here.
//
// The walk is the reference's, so that ties on shared edges pick the same
// triangle: the stackless bitstack (two uint32 trail words, one 8-bit mask
// of untested children per level), a pop takes the lowest set bit of the
// lowest non-empty level; an inner pop does 8 slab tests against the ray's
// best t so far and pushes the mask of the children it hits; a leaf pop
// tests its (up to) 16 triangles in slot order, each against the best t so
// far (t < best, strict), and alpha-tests each triangle that hits. The
// reference tests the 16 against the best t at the pop and takes the first
// of the nearest that pass; testing in slot order against the running best
// takes the same triangle (a later candidate replaces an earlier one only
// when strictly nearer), and the ones it skips could not have won.
//
// The alpha test (render/raytrace.py::as_debug_view's alpha_test, the
// reference shader's candidate confirmation): the triangle's material, its
// packed diffuse ref (image | layer << 16), the barycentric uv, the LOD-0
// bilinear WRAP_REPEAT tap of that layer (atlas_tap.cuh, kernel 2's tap
// code), alpha = factor.a * tap.a (factor.a alone without a texture) and
// alpha >= the material's cutoff.
//
// What bounds it: like kernel 5, the pops' tests, each behind a load whose
// address depends on the previous pop, and lanes of one warp that want
// different work; closest hit has no early exit, so every ray walks until
// its trail is empty. This first design keeps kernel 5's shape (one ray a
// lane, warps that refill below REFILL_BELOW live lanes, inner pops until
// every lane holds a leaf) and is not tuned further.
//
// The arithmetic is ops/bvh.py::_ray_tri_tuv / _ray_aabb and
// ops/texture.py's, term for term in IEEE float32: the library is built
// with --fmad=false and without fast math, so t, u, v and the alpha
// decision round as in the plain version.
#include "atlas_tap.cuh"

namespace {

constexpr int LEAF_TRIS = 16;
constexpr int WIDE = 8;
constexpr int MAX_LEVELS = 7;
constexpr int NODE_F4 = 12;  // 6 planes x 8 children
constexpr int TRI_F4 = 3;    // v0, e1, e2
constexpr int THREADS = 128;
constexpr int REFILL_BELOW = 8;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int LAYER_SHIFT = 16;
constexpr int IMAGE_MASK = (1 << LAYER_SHIFT) - 1;

struct Layout {
    int num_rows, num_leaves, num_tris, num_levels;
    int level_offsets[MAX_LEVELS];
    int children_below[MAX_LEVELS];
};

// What the alpha test reads.
struct AlphaInputs {
    const int* tri_vtx;          // [T, 3] into uvs
    const float* uvs;            // [V, 2]
    const int* tri_material;     // [T]
    const int* tex_diffuse;      // [M] packed refs, -1: none
    const float* alpha_factor;   // [M] diffuse_factor.a
    const float* cutoff;         // [M] alpha_clipping_cutoff
    const uint16_t* quads;       // [R, row_elems] bf16 atlas
    const int* meta;             // [images, meta_stride]
    int row_elems, meta_stride, class_mask, l_max;
};

__device__ __forceinline__ bool ray_tri_tuv(const float4* __restrict__ p, float ox, float oy,
                                            float oz, float dx, float dy, float dz, float t_min,
                                            float t_max, float& t_out, float& u_out,
                                            float& v_out) {
    const float4 v0 = __ldg(p), e1 = __ldg(p + 1), e2 = __ldg(p + 2);
    const float pv0 = dy * e2.z - dz * e2.y;
    const float pv1 = dz * e2.x - dx * e2.z;
    const float pv2 = dx * e2.y - dy * e2.x;
    const float det = e1.x * pv0 + e1.y * pv1 + e1.z * pv2;
    if (!(fabsf(det) > 1e-12f)) return false;
    const float inv_det = 1.0f / det;
    const float tx = ox - v0.x, ty = oy - v0.y, tz = oz - v0.z;
    const float u = (tx * pv0 + ty * pv1 + tz * pv2) * inv_det;
    if (!(u >= 0.0f && u <= 1.0f)) return false;
    const float qv0 = ty * e1.z - tz * e1.y;
    const float qv1 = tz * e1.x - tx * e1.z;
    const float qv2 = tx * e1.y - ty * e1.x;
    const float vv = (dx * qv0 + dy * qv1 + dz * qv2) * inv_det;
    if (!(vv >= 0.0f && u + vv <= 1.0f)) return false;
    const float t = (e2.x * qv0 + e2.y * qv1 + e2.z * qv2) * inv_det;
    if (!(t > t_min && t < t_max)) return false;
    t_out = t;
    u_out = u;
    v_out = vv;
    return true;
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

// The caster's candidate confirmation of triangle `id` hit at (u, v).
__device__ __forceinline__ bool alpha_ok(const AlphaInputs& a, int id, float u, float v) {
    const int mid = a.tri_material[id];
    const int tid = a.tex_diffuse[mid];
    float tap = 1.0f;
    if (tid >= 0) {
        const int i0 = a.tri_vtx[3 * id], i1 = a.tri_vtx[3 * id + 1], i2 = a.tri_vtx[3 * id + 2];
        const float w0 = (1.0f - u) - v;
        const float uv_x = (a.uvs[2 * i0] * w0 + a.uvs[2 * i1] * u) + a.uvs[2 * i2] * v;
        const float uv_y = (a.uvs[2 * i0 + 1] * w0 + a.uvs[2 * i1 + 1] * u) + a.uvs[2 * i2 + 1] * v;
        const int* row = a.meta + (size_t)(tid & IMAGE_MASK) * a.meta_stride;
        const int lc = trt::layer_class(row, a.class_mask);
        int layer = tid >> LAYER_SHIFT;
        layer = layer < a.l_max ? layer : 0;  // a layer past the bundle reads layer 0
        if (layer < lc) {
            const trt::Footprint f =
                trt::level_footprint(row, 0, uv_x, uv_y, trt::WRAP_REPEAT, a.row_elems, lc);
            tap = trt::lerp4(a.quads, f.base, 4 * lc, 4 * layer + 3, f.fx, f.fy);
        } else {
            tap = 0.0f;  // a layer the image lacks reads 0
        }
    }
    return a.alpha_factor[mid] * tap >= a.cutoff[mid];
}

__global__ void __launch_bounds__(THREADS)
bvh_closest_kernel(Layout lay, const float4* __restrict__ nodes, const float4* __restrict__ tris,
                   const int* __restrict__ leaf_ids, AlphaInputs alpha,
                   const float* __restrict__ rays, int n, float t_min, int* __restrict__ next_ray,
                   unsigned char* __restrict__ hit_out, float* __restrict__ t_out,
                   int* __restrict__ tri_out, float* __restrict__ u_out,
                   float* __restrict__ v_out) {
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
    const uint32_t root_mask = 1u << ((D & 3) * 8);

    int ray = -1;  // this lane's ray; -1: the lane is empty
    float ox = 0.f, oy = 0.f, oz = 0.f, ivx = 0.f, ivy = 0.f, ivz = 0.f;
    float dx = 0.f, dy = 0.f, dz = 0.f;
    float best_t = 0.f, best_u = 0.f, best_v = 0.f;
    int best_tri = -1;
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
                            best_t = tm;
                            best_tri = -1;
                            best_u = 0.f;
                            best_v = 0.f;
                            tlo = D < 4 ? root_mask : 0u;
                            thi = D >= 4 ? root_mask : 0u;
                            lvl = D + 1;
                            idx = 0;
                        } else {  // dead: never pops, a miss at t_max
                            hit_out[r] = 0;
                            t_out[r] = tm;
                            tri_out[r] = -1;
                            u_out[r] = 0.f;
                            v_out[r] = 0.f;
                        }
                    }
                }
            }
        }
        if (!__any_sync(FULL, ray >= 0)) break;  // no live ray and none left

        // ---- inner pops until every live lane holds a leaf or is done
        while (true) {
            const bool want = ray >= 0 && !leaf;
            if (!__any_sync(FULL, want)) break;
            if (!want) continue;
            if (tlo == 0u && thi == 0u) {  // trail empty: the walk is over
                hit_out[ray] = best_tri >= 0;
                t_out[ray] = best_t;
                tri_out[ray] = best_tri;
                u_out[ray] = best_u;
                v_out[ray] = best_v;
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
            const int clvl = lvl - 1;
            const int r = min(level_offsets[clvl] + idx, lay.num_rows - 1);
            const float4* row = nodes + (size_t)r * NODE_F4;
            const int n_child = max(min(WIDE, children_below[clvl] - idx * WIDE), 0);
            uint32_t m8 = slab4(row[0], row[2], row[4], row[6], row[8], row[10], ox, oy, oz,
                                ivx, ivy, ivz, best_t);
            m8 |= slab4(row[1], row[3], row[5], row[7], row[9], row[11], ox, oy, oz, ivx, ivy,
                        ivz, best_t)
                  << 4;
            m8 &= (1u << n_child) - 1u;
            const uint32_t add = m8 << ((clvl & 3) * 8);
            if (clvl < 4) tlo |= add;
            else thi |= add;
        }

        // ---- leaf tests of every lane holding a leaf: nearest hit that
        // passes its alpha test, in slot order
        if (leaf) {
            leaf = false;
            const int li = min(idx, lay.num_leaves - 1);
            const float4* p = tris + (size_t)li * LEAF_TRIS * TRI_F4;
            const int n_tris = min(LEAF_TRIS, lay.num_tris - li * LEAF_TRIS);
            for (int k = 0; k < n_tris; ++k) {
                float t, u, v;
                if (ray_tri_tuv(p + TRI_F4 * k, ox, oy, oz, dx, dy, dz, t_min, best_t, t, u,
                                v)) {
                    const int id = leaf_ids[li * LEAF_TRIS + k];
                    if (alpha_ok(alpha, id, u, v)) {
                        best_t = t;
                        best_tri = id;
                        best_u = u;
                        best_v = v;
                    }
                }
            }
        }
    }
}

}  // namespace

// layout: num_rows, num_leaves, num_tris, num_levels, then MAX_LEVELS
// level offsets and MAX_LEVELS child counts. dims: the atlas's row_elems,
// the meta stride, the atlas's layer-class mask and its largest class.
// next_ray: one zeroed int, the fetch counter.
TRT_EXPORT int trt_bvh_closest(const int* layout, const float* nodes, const float* tris,
                               const int* leaf_ids, const int* tri_vtx, const float* uvs,
                               const int* tri_material, const int* tex_diffuse,
                               const float* alpha_factor, const float* cutoff,
                               const uint16_t* quads, const int* meta, const int* dims,
                               const float* rays, int n, float t_min, int* next_ray,
                               unsigned char* hit, float* t, int* tri, float* u, float* v,
                               cudaStream_t stream) {
    Layout lay;
    lay.num_rows = layout[0];
    lay.num_leaves = layout[1];
    lay.num_tris = layout[2];
    lay.num_levels = layout[3];
    for (int k = 0; k < MAX_LEVELS; ++k) {
        lay.level_offsets[k] = layout[4 + k];
        lay.children_below[k] = layout[4 + MAX_LEVELS + k];
    }
    AlphaInputs a;
    a.tri_vtx = tri_vtx;
    a.uvs = uvs;
    a.tri_material = tri_material;
    a.tex_diffuse = tex_diffuse;
    a.alpha_factor = alpha_factor;
    a.cutoff = cutoff;
    a.quads = quads;
    a.meta = meta;
    a.row_elems = dims[0];
    a.meta_stride = dims[1];
    a.class_mask = dims[2];
    a.l_max = dims[3];
    if (n > 0) {
        bvh_closest_kernel<<<trt_resident_blocks((const void*)bvh_closest_kernel, THREADS),
                             THREADS, 0, stream>>>(
            lay, reinterpret_cast<const float4*>(nodes), reinterpret_cast<const float4*>(tris),
            leaf_ids, a, rays, n, t_min, next_ray, hit, t, tri, u, v);
    }
    return trt_launch_status();
}
