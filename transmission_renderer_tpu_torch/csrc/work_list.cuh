// The work list of the segmented depth races (kernels 1 and 6), and the
// 16-byte cp.async copies their races stage records with.
//
// A race cuts each tile slot's list of records into segments of at most
// `segment` records; one (slot, segment) pair is a work item. A one-block
// plan kernel writes the list on the card, so the host never waits to
// learn how many items there are:
//   plan[0]          the race's item counter (left 0),
//   plan[1]          n_slots, the slots with at least one segment,
//   order = plan + 2 [k_tiles]: those slots, most segments first (a
//                    counting sort into PLAN_BUCKETS buckets; counts of
//                    PLAN_BUCKETS - 1 and more share the top bucket),
//   seg_cum = plan + 2 + k_tiles [k_tiles]: the running count of segments
//                    in that order.
// Item i is segment i - seg_cum[p - 1] of slot order[p], for the p with
// seg_cum[p - 1] <= i < seg_cum[p]. The heaviest slots start in the first
// wave of a persistent grid that pulls items from plan[0]. The races merge
// by a maximum, so the order of the slots within a bucket is free.
#pragma once

#include "common.cuh"

namespace work_list {

constexpr int PLAN_THREADS = 1024;
constexpr int PLAN_BUCKETS = 64;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Build the plan on one block of PLAN_THREADS threads; segments(k) is the
// segment count of slot k. plan is not __restrict__: its words are
// written and read by other threads of the block across barriers, so no
// load of it may be moved.
template <class Segments>
__device__ __forceinline__ void build(Segments segments, int k_tiles, int* plan) {
    __shared__ int hist[PLAN_BUCKETS];
    __shared__ int warp_sum[PLAN_THREADS / 32];
    __shared__ int carry, n_slots_sh;
    int* order = plan + 2;
    int* seg_cum = plan + 2 + k_tiles;
    const int t = threadIdx.x;
    if (t < PLAN_BUCKETS) hist[t] = 0;
    __syncthreads();
    for (int k = t; k < k_tiles; k += PLAN_THREADS) {
        const int n = segments(k);
        if (n > 0) atomicAdd(&hist[min(n, PLAN_BUCKETS - 1)], 1);
    }
    __syncthreads();
    if (t == 0) {  // each bucket's first position, the top bucket first
        int run = 0;
        for (int b = PLAN_BUCKETS - 1; b > 0; --b) {
            const int c = hist[b];
            hist[b] = run;
            run += c;
        }
        plan[1] = run;
        n_slots_sh = run;
        carry = 0;
    }
    __syncthreads();
    const int n_slots = n_slots_sh;
    for (int k = t; k < k_tiles; k += PLAN_THREADS) {
        const int n = segments(k);
        if (n > 0) order[atomicAdd(&hist[min(n, PLAN_BUCKETS - 1)], 1)] = k;
    }
    __syncthreads();
    // inclusive scan of the segment counts in that order, 1024 at a time
    const int lane = t & 31, warp = t >> 5;
    for (int base = 0; base < n_slots; base += PLAN_THREADS) {
        const int p = base + t;
        int x = p < n_slots ? segments(__ldcg(order + p)) : 0;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
            if (lane >= d) x += y;
        }
        if (lane == 31) warp_sum[warp] = x;
        __syncthreads();
        if (warp == 0) {
            int w = warp_sum[lane];
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const int y = __shfl_up_sync(0xFFFFFFFFu, w, d);
                if (lane >= d) w += y;
            }
            warp_sum[lane] = w;
        }
        __syncthreads();
        x += carry + (warp > 0 ? warp_sum[warp - 1] : 0);
        if (p < n_slots) seg_cum[p] = x;
        __syncthreads();
        if (t == PLAN_THREADS - 1) carry = x;
        __syncthreads();
    }
}

// Pull the next item (one thread): its slot, or -1 when none is left, and
// its segment's index j within the slot.
__device__ __forceinline__ int pull(int* plan, int k_tiles, int& j) {
    const int* order = plan + 2;
    const int* seg_cum = plan + 2 + k_tiles;
    const int n_slots = plan[1];
    const int n_items = n_slots > 0 ? seg_cum[n_slots - 1] : 0;
    const int it = atomicAdd(plan, 1);
    j = 0;
    if (it >= n_items) return -1;
    int lo = 0, hi = n_slots - 1;  // the first p with seg_cum[p] > it
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (seg_cum[mid] > it) hi = mid;
        else lo = mid + 1;
    }
    j = it - (lo > 0 ? seg_cum[lo - 1] : 0);
    return order[lo];
}

}  // namespace work_list
