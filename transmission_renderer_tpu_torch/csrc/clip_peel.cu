// The alpha-clip peel's re-race bookkeeping: each round's worklist and
// merge around kernel 1.
//
// Replaces no TPU kernel: the reference keeps the peel's state as one
// stacked array and updates it with XLA's gather, select and scatter
// (transmission_renderer_tpu/render/frame.py:805-866, _rasterize_clip_peeled).
// The port's plain versions (render/frame.py::_clip_worklist_plain,
// _clip_merge_plain) do the same in PyTorch.
//
// The state is one buffer [C, n_tiles, 8, 128] of 32-bit words, channel
// major, in kernel 1's output order: tri and material (int32), then its
// float channels, depth first. The alpha tests' results live in ok
// [n_tiles + 1, 8, 128] bytes. A pixel's winner fails where tri >= 0 and
// ok is 0.
//
// Worklist (three launches, no host sync): flag every tile holding a
// failing winner; compact the flagged tiles in ascending order into the
// round's `cap` slots (those past the cap wait for a later round), the
// empty slots taking id n_tiles, and count the flagged tiles (the round's
// demand); then gather kernel 1's two inputs per slot from the slot's
// tile, an empty slot's from the pad tile: the seed depth, and the peel
// bound (the state's depth where the winner failed, +inf elsewhere).
//
// Merge (one launch, after kernel 1): for every slot whose id is below
// n_tiles, the raced channels replace the state where the winner failed,
// and the state's winner replaces the raced channels elsewhere, so that
// the state and kernel 1's output buffers both hold the merged winner,
// which the alpha test (csrc/clip_alpha.cu) then reads. An empty slot
// touches nothing. Pure data movement of 32-bit words: every bit of the
// int channels (-1 is a NaN pattern, small ids are denormals) survives.
//
// Bound: memory. The worklist reads each tile's tri and ok (5 B a pixel)
// and writes 8 B a slot pixel; the merge moves 8 B a channel of each
// live slot's pixel.
#include "common.cuh"

namespace {

constexpr int TILE_PX = 8 * 128;
constexpr int THREADS = 256;  // one block per tile slot, 4 pixels a thread
constexpr int SCAN_THREADS = 1024;
// the most planes one merge takes: their pointers travel in a kernel
// parameter (render/frame.py::_peel_channels lays the state out; the
// entry refuses more)
constexpr int MAX_CHANNELS = 32;

// The 4 pixels at `px` that fail: a bit per pixel.
__device__ __forceinline__ unsigned failing(const int* tri, const uint8_t* ok, size_t at) {
    const int4 t = *reinterpret_cast<const int4*>(tri + at);
    const uchar4 o = *reinterpret_cast<const uchar4*>(ok + at);
    return (unsigned)(t.x >= 0 && !o.x) | (unsigned)(t.y >= 0 && !o.y) << 1 |
           (unsigned)(t.z >= 0 && !o.z) << 2 | (unsigned)(t.w >= 0 && !o.w) << 3;
}

__global__ void __launch_bounds__(THREADS)
peel_flag_kernel(const int* __restrict__ tri, const uint8_t* __restrict__ ok,
                 int* __restrict__ flags) {
    const size_t at = (size_t)blockIdx.x * TILE_PX + threadIdx.x * 4;
    const int any = __syncthreads_or(failing(tri, ok, at) != 0);
    if (threadIdx.x == 0) flags[blockIdx.x] = any;
}

// One block: each thread takes a run of consecutive tiles, so an exclusive
// scan of the runs' counts gives every flagged tile its slot in ascending
// tile order.
__global__ void __launch_bounds__(SCAN_THREADS)
peel_compact_kernel(const int* __restrict__ flags, int n_tiles, int t0, int cap,
                    const int* __restrict__ pad_tile, int* __restrict__ ids,
                    int* __restrict__ race_ids, int* __restrict__ demand) {
    __shared__ int warp_sums[SCAN_THREADS / 32];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int run = (n_tiles + SCAN_THREADS - 1) / SCAN_THREADS;
    const int lo = min(tid * run, n_tiles), hi = min(lo + run, n_tiles);
    int count = 0;
    for (int t = lo; t < hi; ++t) count += flags[t] != 0;
    int incl = count;  // inclusive scan within the warp
    for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += v;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        int w = warp_sums[lane];
        for (int d = 1; d < 32; d <<= 1) {
            const int v = __shfl_up_sync(0xffffffffu, w, d);
            if (lane >= d) w += v;
        }
        warp_sums[lane] = w;  // inclusive over the warps
    }
    __syncthreads();
    int pos = incl - count + (warp > 0 ? warp_sums[warp - 1] : 0);
    const int total = warp_sums[SCAN_THREADS / 32 - 1];
    for (int t = lo; t < hi && pos < cap; ++t) {
        if (flags[t] != 0) {
            ids[pos] = t;
            race_ids[pos] = t + t0;
            ++pos;
        }
    }
    const int pad = *pad_tile + t0;
    for (int s = min(total, cap) + tid; s < cap; s += SCAN_THREADS) {
        ids[s] = n_tiles;
        race_ids[s] = pad;
    }
    if (tid == 0) *demand = total;
}

__global__ void __launch_bounds__(THREADS)
peel_gather_kernel(const int* __restrict__ ids, int n_tiles, const int* __restrict__ pad_tile,
                   const int* __restrict__ tri, const float* __restrict__ depth,
                   const uint8_t* __restrict__ ok, const float* __restrict__ init_tiles,
                   float* __restrict__ init_out, float* __restrict__ max_out) {
    const int id = ids[blockIdx.x];
    const int tile = (unsigned)id < (unsigned)n_tiles ? id : *pad_tile;
    const size_t at = (size_t)tile * TILE_PX + threadIdx.x * 4;
    const size_t out = (size_t)blockIdx.x * TILE_PX + threadIdx.x * 4;
    const unsigned f = failing(tri, ok, at);
    const float4 d = *reinterpret_cast<const float4*>(depth + at);
    const float inf = __int_as_float(0x7f800000);
    *reinterpret_cast<float4*>(init_out + out) = *reinterpret_cast<const float4*>(init_tiles + at);
    *reinterpret_cast<float4*>(max_out + out) =
        make_float4(f & 1 ? d.x : inf, f & 2 ? d.y : inf, f & 4 ? d.z : inf, f & 8 ? d.w : inf);
}

// Kernel 1's output planes, each [slots, 8, 128], in the state's order.
struct Planes {
    uint32_t* p[MAX_CHANNELS];
};

__global__ void __launch_bounds__(THREADS)
peel_merge_kernel(uint32_t* __restrict__ state, int n_channels, int n_tiles,
                  const uint8_t* __restrict__ ok, const int* __restrict__ ids, Planes raced) {
    const int id = ids[blockIdx.x];
    if ((unsigned)id >= (unsigned)n_tiles) return;  // an empty slot
    const size_t plane = (size_t)n_tiles * TILE_PX;
    const size_t at = (size_t)id * TILE_PX + threadIdx.x * 4;
    const size_t out = (size_t)blockIdx.x * TILE_PX + threadIdx.x * 4;
    const unsigned f = failing(reinterpret_cast<const int*>(state), ok, at);
    for (int c = 0; c < n_channels; ++c) {
        uint4* s = reinterpret_cast<uint4*>(state + c * plane + at);
        uint4* r = reinterpret_cast<uint4*>(raced.p[c] + out);
        if (f == 0) {
            *r = *s;  // every winner passed: the state's winner stands
        } else if (f == 0xf) {
            *s = *r;  // every winner failed: the raced layer replaces it
        } else {
            const uint4 a = *s, b = *r;
            const uint4 m = make_uint4(f & 1 ? b.x : a.x, f & 2 ? b.y : a.y,
                                       f & 4 ? b.z : a.z, f & 8 ? b.w : a.w);
            *s = m;
            *r = m;
        }
    }
}

}  // namespace

// tri, depth: the state's planes 0 and PEEL_DEPTH (render/frame.py), each
// [n_tiles, 8, 128]; ok: [n_tiles + 1, 8, 128] bytes; init_tiles:
// [n_tiles, 8, 128]; pad_tile: one int on the card (the local tile empty
// slots race); flags: [n_tiles] ints of scratch; ids, race_ids: [cap]
// (local ids, n_tiles for an empty slot; the tile ids kernel 1 races,
// + t0); demand: one int; init_out, max_out: [cap, 8, 128].
TRT_EXPORT int trt_clip_worklist(const int* tri, const float* depth, const uint8_t* ok,
                                 const float* init_tiles, const int* pad_tile, int n_tiles,
                                 int t0, int cap, int* flags, int* ids, int* race_ids,
                                 int* demand, float* init_out, float* max_out,
                                 cudaStream_t stream) {
    if (n_tiles > 0) peel_flag_kernel<<<n_tiles, THREADS, 0, stream>>>(tri, ok, flags);
    peel_compact_kernel<<<1, SCAN_THREADS, 0, stream>>>(flags, n_tiles, t0, cap, pad_tile,
                                                        ids, race_ids, demand);
    if (cap > 0)
        peel_gather_kernel<<<cap, THREADS, 0, stream>>>(ids, n_tiles, pad_tile, tri, depth,
                                                        ok, init_tiles, init_out, max_out);
    return trt_launch_status();
}

// state: [n_channels, n_tiles, 8, 128] words; ok: [n_tiles + 1, 8, 128]
// bytes; ids: [k_slots]; raced: n_channels pointers to kernel 1's planes
// [k_slots, 8, 128], in the state's channel order.
TRT_EXPORT int trt_clip_merge(uint32_t* state, int n_channels, int n_tiles, const uint8_t* ok,
                              const int* ids, int k_slots, void* const* raced,
                              cudaStream_t stream) {
    if (n_channels < 1 || n_channels > MAX_CHANNELS) return (int)cudaErrorInvalidValue;
    if (k_slots > 0) {
        Planes planes{};
        for (int c = 0; c < n_channels; ++c) planes.p[c] = static_cast<uint32_t*>(raced[c]);
        peel_merge_kernel<<<k_slots, THREADS, 0, stream>>>(state, n_channels, n_tiles, ok,
                                                           ids, planes);
    }
    return trt_launch_status();
}
