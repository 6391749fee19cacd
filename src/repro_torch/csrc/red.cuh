// The RED dequeue-marking coin flip (paper Sec. 2.1 / 3.5), shared by the
// red_mark kernel and the fused departures phase: port q marks at tick
// `tick` when uniform01(tick * 131071 + q, salt) < clamp((qs - kmin) /
// kspan, 0, 1).  The first hash lane wraps modulo 2^32 as the reference's
// i32 product does (computed unsigned: signed overflow is undefined in
// C++); uint32 -> f32 rounds to nearest, as astype(float32) does; the
// quotient is an IEEE divide (no --use_fast_math, and --fmad=false
// contracts nothing), so the flip is bit-equal to the plain version's.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "hash.cuh"

__device__ __forceinline__ bool red_flip(int qs, float kmin, float kspan,
                                         uint32_t tick, uint32_t q,
                                         uint32_t salt) {
    const float p = fmin_t(fmax_t(((float)qs - kmin) / kspan, 0.0f), 1.0f);
    const uint32_t h = mix32(hash2(tick * 131071u + q, salt));
    return __uint2float_rn(h) * (1.0f / 4294967296.0f) < p;
}
