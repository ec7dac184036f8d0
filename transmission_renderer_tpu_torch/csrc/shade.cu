// Fused deferred shade: the opaque fragment shader, or the transmission
// fragment shader up to its framebuffer/LUT fetches. One thread per pixel.
//
// Replaces the TPU kernel transmission_renderer_tpu/render/shade_kernel.py
// ::_make_kernel (pl.pallas_call at shade_kernel.py:965). Per pixel: the
// material row (direct index into the [n_mat, 29] matrix, where the TPU
// ran a where-chain), the texture factors from the tap kernel's sample
// planes, the optional cotangent-frame normal map, the material
// invariants, the sun, the cluster (z-slice from the depth, x/y from the
// pixel) and its light list read straight from the per-cluster table
// (the TPU's per-block candidate where-chain is gone; the list is
// id-ascending, so lights add in the oracle's order), basic_brdf and, in
// transmission mode, transmission_btdf and the refraction ray with its
// exit point's screen uv and framebuffer lod. Opaque writes 3 planes,
// transmission the 32 planes of shade_kernel.py::TRANS_NAMES.
//
// With ray-traced shadows two optional inputs scale the lights
// (shade_kernel.py:486-493, :550-551 of the reference): a sun factor
// plane [M] (floored at 0.1 in the opaque variant, the ambient floor of
// lighting.rs:166; raw in the transmission variant) and per-light factor
// planes [L, M], read at the light id of each cluster slot. A null
// pointer means no factor, and the kernel then does what it did without
// them.
//
// What bounds it: the per-pixel planes it reads and writes (bytes bound
// it on the 1080p frames), beside ~170 operations of set-up per valid
// pixel and ~120 per light (~360 and ~240 with the BTDF):
// render/shade_kernel.py::shade_work counts both on a call's data.
// The design:
// - Invalid pixels (sky; pixels without glass in the transmission
//   worklist) read the valid plane, write their zeros and leave before
//   any shading. Pixels come in 128-pixel row blocks, so whole warps of
//   sky leave together.
// - The material matrix and the light matrix are staged in shared memory
//   once per block; a grid of resident blocks strides over the row blocks.
// - Each lane reads its cluster's light list (id-ascending, so lights add
//   in the oracle's order). A warp loading a list shared by its lanes
//   once (__match_any_sync, 80% of the 1080p frame's warps) measured 2.5%
//   slower on an H100: the two-light lists are L1 hits (PERF.md, Findings).
// - The opaque and transmission variants are two instantiations, each
//   with its own registers; the transmission variant writes each output
//   plane as soon as it is final.
// The plain version is render/shade_kernel.py::fused_shade_plain, in the
// same op order; the library is built without fast math, so division and
// sqrt are IEEE and only log2f/cosf may differ from the plain version by
// an ulp (a cluster-boundary pixel can then pick the neighbouring
// z-slice).
#include "common.cuh"

namespace {

constexpr float F32_EPSILON = 1.1920929e-07f;
constexpr int MAT_COLS = 29;
constexpr int C_METALLIC = 0, C_ROUGHNESS = 1, C_DIFFUSE = 2, C_EMISSIVE = 6;
constexpr int C_IOR = 9, C_TRANSMISSION = 10, C_THICKNESS = 11, C_ATT_DIST = 12;
constexpr int C_ATT_COLOUR = 13, C_SPEC_FACTOR = 16, C_SPEC_COLOUR = 17;
constexpr int C_ATT_ISINF = 20, C_TID0 = 21;
constexpr int N_PIX_BASE = 9;
constexpr int N_TRANS_OUT = 32;
// 128-pixel row blocks, 4 warps each. With at least 6 blocks resident per
// SM ptxas fits the opaque and transmission variants in 64 and 78
// registers without spills: 4% faster on the 1080p RT frame on an H100
// than no cap (PERF.md, Findings)
constexpr int SHADE_THREADS = 128;
constexpr int SHADE_MIN_BLOCKS = 6;

struct ShadeParams {
    int n_mat, n_lights, n_slots, n_layers, tex_flags, ncx, ncy, n_slices,
        transmission, m, n_samples;
    int slot_bundle[8];
    float rcp_csx, rcp_csy, coeff_scale, coeff_bias, lin_num, zsum, zdiff, log2_fbw;
    float pi_f32, frac_1_pi_f32;
};

struct V3 {
    float x, y, z;
};
__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 scale(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
__device__ __forceinline__ float dot_raw(V3 a, V3 b) { return (a.x * b.x + a.y * b.y) + a.z * b.z; }
__device__ __forceinline__ float dotc(V3 a, V3 b) { return fmaxf(dot_raw(a, b), F32_EPSILON); }
__device__ __forceinline__ V3 norm(V3 v) {
    const float inv = 1.0f / sqrtf(dot_raw(v, v));
    return v3(v.x * inv, v.y * inv, v.z * inv);
}
__device__ __forceinline__ float pow5(float x) {
    const float x2 = x * x;
    return x2 * x2 * x;
}

struct Material {
    V3 diffuse, c_diff, f0, f90;
    float ar;
};

__device__ __forceinline__ float d_ggx(float noh, float ar, float pi) {
    const float a2 = ar * ar;
    const float f = (noh * noh) * (a2 - 1.0f) + 1.0f;
    return (f * f > 0.0f) ? a2 / (pi * f * f) : 0.0f;
}

__device__ __forceinline__ float v_smith(float nov, float nol, float ar) {
    const float a2 = ar * ar;
    const float ggx_v = nol * sqrtf(nov * nov * (1.0f - a2) + a2);
    const float ggx_l = nov * sqrtf(nol * nol * (1.0f - a2) + a2);
    const float ggx = ggx_v + ggx_l;
    return (ggx > 0.0f) ? 0.5f / ggx : 0.0f;
}

__device__ __forceinline__ V3 fresnel(float voh, V3 f0, V3 f90) {
    const float t = pow5(1.0f - voh);
    return v3(f0.x + (f90.x - f0.x) * t, f0.y + (f90.y - f0.y) * t, f0.z + (f90.z - f0.z) * t);
}

// pbr/brdf.py::basic_brdf
__device__ __forceinline__ void basic_brdf(V3 normal, V3 light, V3 intensity, V3 view,
                                           const Material& m, const ShadeParams& p,
                                           V3& acc_d, V3& acc_s, bool first) {
    const V3 halfway = norm(view + light);
    const float noh = dotc(normal, halfway);
    const float nov = dotc(normal, view);
    const float nol = dotc(normal, light);
    const float voh = dotc(view, halfway);
    const V3 fr = fresnel(voh, m.f0, m.f90);
    const V3 radiance = scale(intensity, nol);
    const float dweight = (1.0f - fmaxf(fmaxf(fr.x, fr.y), fr.z)) * p.frac_1_pi_f32;
    const V3 diffuse = mul(radiance, scale(m.c_diff, dweight));
    const float dv = d_ggx(noh, m.ar, p.pi_f32) * v_smith(nov, nol, m.ar);
    const V3 specular = mul(scale(radiance, dv), fr);
    if (first) {
        acc_d = diffuse;
        acc_s = specular;
    } else {
        acc_d = acc_d + diffuse;
        acc_s = acc_s + specular;
    }
}

// pbr/brdf.py::transmission_btdf
__device__ __forceinline__ V3 transmission_btdf(V3 normal, V3 light, V3 view, const Material& m,
                                                float trans_rough, const ShadeParams& p) {
    const float l_dot_n = dot_raw(v3(-light.x, -light.y, -light.z), normal);
    const V3 lm = norm(light + scale(normal, 2.0f * l_dot_n));
    const V3 halfway = norm(view + lm);
    const float noh = dotc(normal, halfway);
    const float voh = dotc(view, halfway);
    const float nov = dotc(normal, view);
    const float nol_m = dotc(normal, lm);
    const float dv = d_ggx(noh, trans_rough, p.pi_f32) * v_smith(nov, nol_m, trans_rough);
    const V3 fr = fresnel(voh, m.f0, m.f90);
    return v3((1.0f - fr.x) * dv * m.diffuse.x, (1.0f - fr.y) * dv * m.diffuse.y,
              (1.0f - fr.z) * dv * m.diffuse.z);
}

// One pixel. Invalid pixels (sky, or no glass in the transmission
// worklist) write their zeros and leave.
template <bool T>
__device__ __forceinline__ void shade_pixel(const ShadeParams& p, int i,
                                            const float* __restrict__ scalars,
                                            const float* s_mat, const float* s_lmat,
                                            const int* __restrict__ counts,
                                            const int* __restrict__ indices,
                                            const int* __restrict__ block_py,
                                            const int* __restrict__ block_px0,
                                            const float* __restrict__ pix,
                                            const int* __restrict__ mid_in,
                                            const float* __restrict__ samples,
                                            const float* __restrict__ sun_f,
                                            const float* __restrict__ light_f,
                                            float* __restrict__ out) {
    const size_t M = (size_t)p.m;
    auto plane = [&](int k) { return pix[(size_t)k * M + i]; };
    auto write = [&](int k, float v) { out[(size_t)k * M + i] = v; };
    if (!(plane(7) > 0.5f)) {
        for (int k = 0; k < (T ? N_TRANS_OUT : 3); ++k) write(k, 0.0f);
        return;
    }
    const bool use_diffuse = p.tex_flags & 1, use_mr = p.tex_flags & 2,
               use_normal = p.tex_flags & 4, use_emissive = p.tex_flags & 8,
               use_tr = p.tex_flags & 32, use_th = p.tex_flags & 64,
               use_spec = p.tex_flags & 128, use_spec_col = p.tex_flags & 256;

    const V3 pos = v3(plane(0), plane(1), plane(2));
    const V3 nrm = v3(plane(3), plane(4), plane(5));
    const float depth = plane(6);
    const int mid = min(max(mid_in[i], 0), p.n_mat - 1);
    const float* mrow = s_mat + mid * MAT_COLS;

    // (tid, 4 sample channels) of a texture slot; imat = _MAT_SLOTS index
    auto slot_sample = [&](int imat, float s[4]) {
        const int tid = (int)mrow[C_TID0 + imat];
        int layer = max(tid, 0) >> 16;
        if (layer >= p.n_layers) layer = 0;
        const int base = p.slot_bundle[imat] * 4 * p.n_layers + 4 * layer;
        for (int c = 0; c < 4; ++c) s[c] = samples[(size_t)(base + c) * M + i];
        return tid;
    };

    float s[4];
    V3 diffuse = v3(mrow[C_DIFFUSE], mrow[C_DIFFUSE + 1], mrow[C_DIFFUSE + 2]);
    if (use_diffuse && slot_sample(0, s) >= 0)
        diffuse = v3(diffuse.x * s[0], diffuse.y * s[1], diffuse.z * s[2]);
    float metallic = mrow[C_METALLIC], roughness = mrow[C_ROUGHNESS];
    if (use_mr && slot_sample(1, s) >= 0) {
        metallic = metallic * s[2];
        roughness = roughness * s[1];
    }
    V3 spec_colour = v3(mrow[C_SPEC_COLOUR], mrow[C_SPEC_COLOUR + 1], mrow[C_SPEC_COLOUR + 2]);
    if (use_spec_col && slot_sample(7, s) >= 0)
        spec_colour = v3(spec_colour.x * s[0], spec_colour.y * s[1], spec_colour.z * s[2]);
    float spec_factor = mrow[C_SPEC_FACTOR];
    if (use_spec && slot_sample(6, s) >= 0) spec_factor = spec_factor * s[3];
    V3 emission = v3(mrow[C_EMISSIVE], mrow[C_EMISSIVE + 1], mrow[C_EMISSIVE + 2]);
    if (use_emissive && slot_sample(3, s) >= 0)
        emission = v3(emission.x * s[0], emission.y * s[1], emission.z * s[2]);

    const float ninv = 1.0f / fmaxf(sqrtf(dot_raw(nrm, nrm)), 1e-12f);
    V3 normal = scale(nrm, ninv);
    if (use_normal && slot_sample(2, s) >= 0) {
        const V3 mn = v3(s[0] * (255.0f / 127.0f) - (128.0f / 127.0f),
                         s[1] * (255.0f / 127.0f) - (128.0f / 127.0f),
                         s[2] * (255.0f / 127.0f) - (128.0f / 127.0f));
        const int d = N_PIX_BASE;
        const V3 dpx = v3(plane(d + 0), plane(d + 1), plane(d + 2));
        const V3 dpy = v3(plane(d + 3), plane(d + 4), plane(d + 5));
        const float duvx_u = plane(d + 6), duvx_v = plane(d + 7);
        const float duvy_u = plane(d + 8), duvy_v = plane(d + 9);
        const V3 dp2perp = v3(dpy.y * normal.z - dpy.z * normal.y,
                              dpy.z * normal.x - dpy.x * normal.z,
                              dpy.x * normal.y - dpy.y * normal.x);
        const V3 dp1perp = v3(normal.y * dpx.z - normal.z * dpx.y,
                              normal.z * dpx.x - normal.x * dpx.z,
                              normal.x * dpx.y - normal.y * dpx.x);
        const V3 t = scale(dp2perp, duvx_u) + scale(dp1perp, duvy_u);
        const V3 bt = scale(dp2perp, duvx_v) + scale(dp1perp, duvy_v);
        const float invmax = 1.0f / sqrtf(fmaxf(fmaxf(dot_raw(t, t), dot_raw(bt, bt)), 1e-20f));
        const V3 mapped = (scale(t, invmax * mn.x) + scale(bt, invmax * mn.y)) + scale(normal, mn.z);
        const float minv = 1.0f / fmaxf(sqrtf(dot_raw(mapped, mapped)), 1e-12f);
        normal = scale(mapped, minv);
    }

    // material invariants (pbr/brdf.py::material_invariants)
    const float ior = mrow[C_IOR];
    Material m;
    m.diffuse = diffuse;
    m.ar = roughness * roughness;
    m.c_diff = scale(diffuse, 1.0f - metallic);
    const float root = (ior - 1.0f) / (ior + 1.0f);
    const V3 d0 = scale(spec_colour, (root * root) * spec_factor);
    m.f0 = v3(d0.x + (diffuse.x - d0.x) * metallic, d0.y + (diffuse.y - d0.y) * metallic,
              d0.z + (diffuse.z - d0.z) * metallic);
    const float f90v = spec_factor + (1.0f - spec_factor) * metallic;
    m.f90 = v3(f90v, f90v, f90v);
    float trans_rough = 0.0f, ray_len = 0.0f;
    if (T) {
        // the planes that are final now leave now: fewer values stay live
        // through the light loop
        float trans_factor = mrow[C_TRANSMISSION];
        if (use_tr && slot_sample(4, s) >= 0) trans_factor = trans_factor * s[0];
        float thickness = mrow[C_THICKNESS];
        if (use_th && slot_sample(5, s) >= 0) thickness = thickness * s[1];
        trans_rough = m.ar * fminf(fmaxf(ior * 2.0f - 2.0f, 0.0f), 1.0f);
        ray_len = thickness * plane(8);
        write(11, p.log2_fbw * (roughness * fminf(fmaxf(ior * 2.0f - 2.0f, 0.0f), 1.0f)));
        write(12, ray_len);
        write(14, roughness);
        write(15, trans_factor);
        write(16, mrow[C_ATT_ISINF] > 0.5f ? __int_as_float(0x7f800000) : mrow[C_ATT_DIST]);
        write(17, mrow[C_ATT_COLOUR]);
        write(18, mrow[C_ATT_COLOUR + 1]);
        write(19, mrow[C_ATT_COLOUR + 2]);
        write(20, diffuse.x);
        write(21, diffuse.y);
        write(22, diffuse.z);
        write(23, m.f0.x);
        write(24, m.f0.y);
        write(25, m.f0.z);
        write(26, f90v);
        write(27, f90v);
        write(28, f90v);
        write(29, emission.x);
        write(30, emission.y);
        write(31, emission.z);
    }

    const V3 view_vec = v3(scalars[0] - pos.x, scalars[1] - pos.y, scalars[2] - pos.z);
    const float vinv = 1.0f / fmaxf(sqrtf(dot_raw(view_vec, view_vec)), 1e-12f);
    const V3 view = scale(view_vec, vinv);

    // sun (shader/src/lighting.rs:145-170)
    const V3 sdir = v3(scalars[3], scalars[4], scalars[5]);
    V3 sun_i = v3(scalars[6], scalars[7], scalars[8]);
    if (sun_f != nullptr) {
        const float f = T ? sun_f[i] : fmaxf(sun_f[i], 0.1f);
        sun_i = v3(sun_i.x * f, sun_i.y * f, sun_i.z * f);
    }
    V3 acc_d, acc_s, acc_t = v3(0.f, 0.f, 0.f);
    basic_brdf(normal, sdir, sun_i, view, m, p, acc_d, acc_s, true);
    if (T) acc_t = mul(sun_i, transmission_btdf(normal, sdir, view, m, trans_rough, p));

    // cluster (shader/src/lib.rs:205-215)
    const float depth_range = 2.0f * (1.0f - depth) - 1.0f;
    const float lin = p.lin_num / (p.zsum - depth_range * p.zdiff);
    const float slice_f = log2f(lin) * p.coeff_scale + p.coeff_bias;
    const int zsl = min((int)fmaxf(slice_f, 0.0f), p.n_slices - 1);
    const int blk = i >> 7;
    const float px = (float)block_px0[blk] + (float)(i & 127);
    const int cx = min((int)((px + 0.5f) * p.rcp_csx), p.ncx - 1);
    const int cy = min((int)(((float)block_py[blk] + 0.5f) * p.rcp_csy), p.ncy - 1);
    const int cluster = zsl * (p.ncx * p.ncy) + cy * p.ncx + cx;
    const int count = min(counts[cluster], p.n_slots);
    // id-ascending, so lights add in the oracle's order
    for (int slot = 0; slot < count; ++slot) {
        const int lid = indices[(size_t)cluster * p.n_slots + slot];
        const float* lrow = s_lmat + lid * 12;
        const V3 vec = v3(lrow[0] - pos.x, lrow[1] - pos.y, lrow[2] - pos.z);
        const float dist_sq = dot_raw(vec, vec);
        const float dinv = 1.0f / sqrtf(dist_sq);
        const V3 direction = scale(vec, dinv);
        const float attenuation = 1.0f / dist_sq;
        float factor = 1.0f;
        if (light_f != nullptr) factor = factor * light_f[(size_t)lid * M + i];
        if (!T && lrow[11] > 0.5f) {
            // only evaluate_lights applies the spot factor (lighting.rs:201-203)
            const float eps = lrow[10] == 0.0f ? 1.0f : lrow[10];
            const float theta =
                dot_raw(v3(-direction.x, -direction.y, -direction.z), v3(lrow[6], lrow[7], lrow[8]));
            factor = factor * fmaxf((theta - cosf(lrow[9])) / eps, 0.0f);
        }
        const float w = factor * attenuation;
        const V3 radiance = v3(lrow[3] * w, lrow[4] * w, lrow[5] * w);
        basic_brdf(normal, direction, radiance, view, m, p, acc_d, acc_s, false);
        if (T) acc_t = acc_t + mul(radiance, transmission_btdf(normal, direction, view, m, trans_rough, p));
    }

    if (!T) {
        const V3 o = (acc_d + acc_s) + emission;
        write(0, o.x);
        write(1, o.y);
        write(2, o.z);
        return;
    }
    write(0, acc_d.x);
    write(1, acc_d.y);
    write(2, acc_d.z);
    write(3, acc_s.x);
    write(4, acc_s.y);
    write(5, acc_s.z);
    write(6, acc_t.x);
    write(7, acc_t.y);
    write(8, acc_t.z);

    // refraction ray (glam-pbr ibl_volume_refraction, lib.rs:292-345); the
    // reference's unguarded sqrt (NaN on total internal reflection) is kept
    const float eta = 1.0f / ior;
    const V3 inc = v3(-view.x, -view.y, -view.z);
    const float n_dot_i = dot_raw(normal, inc);
    const float kk = 1.0f - eta * eta * (1.0f - n_dot_i * n_dot_i);
    const float coef = eta * n_dot_i + sqrtf(kk);
    const V3 refr = v3(eta * inc.x - coef * normal.x, eta * inc.y - coef * normal.y,
                       eta * inc.z - coef * normal.z);
    const float rinv = 1.0f / sqrtf(dot_raw(refr, refr));
    const V3 ex = v3(pos.x + refr.x * rinv * ray_len, pos.y + refr.y * rinv * ray_len,
                     pos.z + refr.z * rinv * ray_len);
    auto dc = [&](int row) {
        const float* r = scalars + 16 + 4 * row;
        return ((r[0] * ex.x + r[1] * ex.y) + r[2] * ex.z) + r[3];
    };
    const float dcw = dc(3);
    write(9, (dc(0) / dcw + 1.0f) * 0.5f);
    write(10, (dc(1) / dcw + 1.0f) * 0.5f);
    write(13, dot_raw(normal, view));
}

// The material and light tables are staged in shared memory once per
// block; the block then shades 128-pixel row blocks, a grid's stride apart
// (the grid is as many blocks as the card holds resident).
template <bool T>
__global__ void __launch_bounds__(SHADE_THREADS, SHADE_MIN_BLOCKS)
shade_kernel(ShadeParams p, const float* __restrict__ scalars, const float* __restrict__ mat,
             const float* __restrict__ lmat, const int* __restrict__ counts,
             const int* __restrict__ indices, const int* __restrict__ block_py,
             const int* __restrict__ block_px0, const float* __restrict__ pix,
             const int* __restrict__ mid_in, const float* __restrict__ samples,
             const float* __restrict__ sun_f, const float* __restrict__ light_f,
             float* __restrict__ out) {
    extern __shared__ float smem[];
    float* s_mat = smem;
    float* s_lmat = s_mat + p.n_mat * MAT_COLS;
    for (int k = threadIdx.x; k < p.n_mat * MAT_COLS; k += SHADE_THREADS) s_mat[k] = mat[k];
    for (int k = threadIdx.x; k < p.n_lights * 12; k += SHADE_THREADS) s_lmat[k] = lmat[k];
    __syncthreads();
    for (int blk = blockIdx.x; blk < p.m / SHADE_THREADS; blk += gridDim.x)
        shade_pixel<T>(p, blk * SHADE_THREADS + threadIdx.x, scalars, s_mat, s_lmat, counts,
                       indices, block_py, block_px0, pix, mid_in, samples, sun_f, light_f, out);
}

template <bool T>
void launch(const ShadeParams& p, const float* scalars, const float* mat, const float* lmat,
            const int* counts, const int* indices, const int* block_py, const int* block_px0,
            const float* pix, const int* mid, const float* samples, const float* sun_f,
            const float* light_f, float* out, cudaStream_t stream) {
    const size_t smem = sizeof(float) * (p.n_mat * MAT_COLS + p.n_lights * 12);
    const int blocks = p.m / SHADE_THREADS;
    const int resident = trt_resident_blocks(reinterpret_cast<const void*>(&shade_kernel<T>),
                                             SHADE_THREADS, smem);
    shade_kernel<T><<<blocks < resident ? blocks : resident, SHADE_THREADS, smem, stream>>>(
        p, scalars, mat, lmat, counts, indices, block_py, block_px0, pix, mid, samples, sun_f,
        light_f, out);
}

}  // namespace

TRT_EXPORT int trt_shade(const int* iparams, const float* fparams, const float* scalars,
                         const float* mat, const float* lmat, const int* counts,
                         const int* indices, const int* block_py, const int* block_px0,
                         const float* pix, const int* mid, const float* samples,
                         const float* sun_f, const float* light_f, float* out,
                         cudaStream_t stream) {
    ShadeParams p;
    p.n_mat = iparams[0];
    p.n_lights = iparams[1];
    p.n_slots = iparams[2];
    p.n_layers = iparams[3];
    p.tex_flags = iparams[4];
    p.ncx = iparams[5];
    p.ncy = iparams[6];
    p.n_slices = iparams[7];
    p.transmission = iparams[8];
    p.m = iparams[9];
    p.n_samples = iparams[10];
    for (int k = 0; k < 8; ++k) p.slot_bundle[k] = iparams[11 + k];
    p.rcp_csx = fparams[0];
    p.rcp_csy = fparams[1];
    p.coeff_scale = fparams[2];
    p.coeff_bias = fparams[3];
    p.lin_num = fparams[4];
    p.zsum = fparams[5];
    p.zdiff = fparams[6];
    p.log2_fbw = fparams[7];
    p.pi_f32 = 3.14159265358979323846f;
    p.frac_1_pi_f32 = (float)(1.0 / 3.14159265358979323846);
    if (p.m % SHADE_THREADS != 0 || p.n_mat < 1) return (int)cudaErrorInvalidValue;
    if (p.m > 0) {
        if (p.transmission)
            launch<true>(p, scalars, mat, lmat, counts, indices, block_py, block_px0, pix, mid,
                         samples, sun_f, light_f, out, stream);
        else
            launch<false>(p, scalars, mat, lmat, counts, indices, block_py, block_px0, pix, mid,
                          samples, sun_f, light_f, out, stream);
    }
    return trt_launch_status();
}
