// The lane axis of the fused tick kernels: a study's lanes in one launch.
//
// Every tick kernel runs one grid row a lane (blockIdx.y).  Its argument
// struct starts with its pointers, followed by `ls`, each pointer's lane
// stride in bytes: the row of a state buffer, or 0 for a constant all
// lanes share.  A block first reads its lane's gate and tick (a lane that
// is not live returns at once, so it stays bitwise as it was), then moves
// every pointer to its lane's rows with at_lane and runs the single-lane
// body unchanged.
#pragma once

#include "common.cuh"

template <int kPtrs, typename Args>
__device__ __forceinline__ Args at_lane(Args a, int lane) {
    static_assert(sizeof(void*) == sizeof(char*), "pointer fields");
    char** p = reinterpret_cast<char**>(&a);
#pragma unroll
    for (int i = 0; i < kPtrs; ++i)
        if (p[i]) p[i] += (long long)lane * a.ls[i];
    return a;
}
