// Shared helpers of the port's CUDA kernels.
//
// Every entry point is a plain C function: device pointers and the stream
// come in as void*, and the function returns cudaGetLastError() after its
// launch, so that the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>

#define DTC_EXPORT extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
    return fminf(fmaxf(x, lo), hi);
}
