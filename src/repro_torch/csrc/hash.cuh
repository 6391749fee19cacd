// The splitmix32-style counter hash of the simulator (netsim/hashing.py),
// in native uint32: ECMP path selection, REPS spraying and RED marking.
// Each lane is the two's-complement bits of an i32 (or a uint32 salt);
// the products wrap modulo 2^32, computed unsigned because signed
// overflow is undefined in C++.
#pragma once

#include <cstdint>

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
    return x;
}

__device__ __forceinline__ uint32_t hash2(uint32_t a, uint32_t b) {
    return mix32(a * 0x9E3779B9u + mix32(b));
}
