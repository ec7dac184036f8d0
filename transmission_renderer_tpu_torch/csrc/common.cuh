// Shared definitions of the port's CUDA kernels.
//
// Every kernel is exported through a plain C entry point that takes raw
// device pointers and a stream, launches, and returns cudaGetLastError()
// (the Python wrapper raises when it is not cudaSuccess). Kernels
// allocate nothing; the wrappers allocate outputs with torch.empty.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define TRT_EXPORT extern "C" __attribute__((visibility("default")))

// Finish a C entry point: report a refused launch.
static inline int trt_launch_status() { return (int)cudaGetLastError(); }

// Blocks of `threads` threads of `kernel` (with `smem` bytes of dynamic
// shared memory) that the card holds resident at once (at least one per
// SM): the grid of a persistent kernel.
static inline int trt_resident_blocks(const void* kernel, int threads, size_t smem = 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    return sms * (per_sm > 0 ? per_sm : 1);
}
