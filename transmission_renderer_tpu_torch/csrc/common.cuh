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
