// Helpers shared by the tick kernels.  Every kernel is exported through a
// plain C launcher (no PyTorch headers: route (b), ctypes-bound) that
// launches on the caller's stream and returns cudaGetLastError().
#pragma once

#include <cuda_runtime.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

// The reference's integer `%` and `//` are floor operations (the result of
// `%` takes the divisor's sign); C++'s truncate.  Every index expression
// that follows the reference goes through these.
__device__ __forceinline__ int floor_mod(int a, int b) {
    int r = a % b;
    return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

__device__ __forceinline__ int floor_div(int a, int b) {
    int q = a / b;
    return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// torch.maximum / torch.minimum for values that are never NaN.
__device__ __forceinline__ float fmax_t(float a, float b) { return a > b ? a : b; }
__device__ __forceinline__ float fmin_t(float a, float b) { return a < b ? a : b; }
