// The alpha-clip peel's alpha test: one thread per pixel of the raced
// tiles' winners.
//
// Replaces no TPU kernel: the reference's test
// (transmission_renderer_tpu/render/frame.py::_clip_alpha_ok_tiles) is
// XLA code, and so is the port's plain version
// (render/frame.py::_clip_alpha_ok_tiles, scattered by the slots' tile
// ids). Each round of the peel (render/frame.py::_rasterize_clip_peeled)
// races a worklist of tile slots; this kernel reads the winners' tiled
// channels [slots, 8, 128] (tri, material, the analytic uv and its x and
// y derivatives), tests each winner's diffuse alpha against its
// material's cutoff (atlas_tap.cuh's diffuse_alpha_test, kernel 6's alpha
// form's test) and writes the result straight into the peel's ok state
// [n_tiles + 1, 8, 128] at the slot's tile id: the scatter is fused. A
// slot whose id is n_tiles or more is empty and writes nothing; a pixel
// with no winner (tri < 0) passes without a tap.
//
// Bound: memory. Each pixel reads its 8 channels (32 B) and writes 1 B;
// a textured winner adds two 2x2 bf16 footprints of the atlas (mostly L2
// hits: the foliage's alpha masks are small).
#include "atlas_tap.cuh"

namespace {

constexpr int TILE_PX = 8 * 128;
constexpr int THREADS = 256;

// The winners' tiled channels, each [slots, 8, 128].
struct Winners {
    const int *tri, *material;
    const float *uv_u, *uv_v, *dx_u, *dx_v, *dy_u, *dy_v;
};

__global__ void __launch_bounds__(THREADS)
clip_alpha_kernel(Winners w, const int* __restrict__ ids, int n_tiles, trt::AlphaMaterials mat,
                  uint8_t* __restrict__ ok) {
    const int slot = blockIdx.x;
    const int id = ids[slot];
    if ((unsigned)id >= (unsigned)n_tiles) return;  // an empty slot
    const int px = blockIdx.y * THREADS + threadIdx.x;
    const size_t at = (size_t)slot * TILE_PX + px;
    bool keep = true;
    if (w.tri[at] >= 0) {
        const int mid = max(w.material[at], 0);
        keep = trt::diffuse_alpha_test<false>(mat, mid, [&](float* uv, float* dx, float* dy) {
                   uv[0] = w.uv_u[at];
                   uv[1] = w.uv_v[at];
                   dx[0] = w.dx_u[at];
                   dx[1] = w.dx_v[at];
                   dy[0] = w.dy_u[at];
                   dy[1] = w.dy_v[at];
               }) == trt::ALPHA_KEEP;
    }
    ok[(size_t)id * TILE_PX + px] = keep;
}

}  // namespace

// channels: tri, material, uv_u, uv_v, duvdx_u, duvdx_v, duvdy_u, duvdy_v,
// each [k_slots, 8, 128]; ids: [k_slots] tile ids (n_tiles or more: an
// empty slot); diffuse_factor: [M, factor_stride] (its column 3 is read);
// ok: [n_tiles + 1, 8, 128] bytes, written at the slots' ids only.
TRT_EXPORT int trt_clip_alpha(const void* const* channels, const int* ids, int k_slots,
                              int n_tiles, const int* tex_diffuse, const float* diffuse_factor,
                              int factor_stride, const float* cutoff, const uint16_t* quads,
                              int row_elems, const int* meta, int n_images, int meta_stride,
                              int class_mask, int l_max, uint8_t* ok, cudaStream_t stream) {
    if (k_slots > 0) {
        Winners w;
        w.tri = static_cast<const int*>(channels[0]);
        w.material = static_cast<const int*>(channels[1]);
        w.uv_u = static_cast<const float*>(channels[2]);
        w.uv_v = static_cast<const float*>(channels[3]);
        w.dx_u = static_cast<const float*>(channels[4]);
        w.dx_v = static_cast<const float*>(channels[5]);
        w.dy_u = static_cast<const float*>(channels[6]);
        w.dy_v = static_cast<const float*>(channels[7]);
        trt::AlphaMaterials mat{};
        mat.tex_diffuse = tex_diffuse;
        mat.alpha_factor = diffuse_factor + 3;  // diffuse_factor[:, 3]
        mat.factor_stride = factor_stride;
        mat.cutoff = cutoff;
        mat.quads = quads;
        mat.row_elems = row_elems;
        mat.meta = meta;
        mat.n_images = n_images;
        mat.meta_stride = meta_stride;
        mat.class_mask = class_mask;
        mat.l_max = l_max;
        clip_alpha_kernel<<<dim3(k_slots, TILE_PX / THREADS), THREADS, 0, stream>>>(
            w, ids, n_tiles, mat, ok);
    }
    return trt_launch_status();
}
