// RED dequeue-marking coin flip and trim admission over every port queue
// (paper Sec. 2.1 and 3.3).
//
// Replaces the TPU kernel src/repro/kernels/red_mark/kernel.py:42
// `red_mark` (pl.pallas_call at :57), whose body is
// repro/kernels/red_mark/ref.py:9 `red_mark_ref`.
//
// Bound on an H100: memory, nominally.  Per queue it reads two i32 and
// writes a bool and two i32 (17 B): about 39 KB at perm_1024n_3t's
// Q = 2304, or 0.012 us at 3.35 TB/s.  Launch latency sets its time.
//
// Design: one thread per queue; the (8, 128) tile padding of the TPU
// kernel is dropped and the global queue index is the thread's own.  The
// coin flip is red.cuh's red_flip (the splitmix32 hash natively in uint32,
// the reference's lanes, repro/netsim/hashing.py:38-44; an IEEE divide),
// shared with the fused departures phase, with the span max(kmax - kmin,
// 1e-6) in f32, so every decision is bit-equal to the plain PyTorch
// version.  tick and salt arrive as i32, as the reference's ref takes them
// (its Pallas kernel packs them into an f32 row, which rounds them from
// 2^24 on).
#include <cstdint>

#include "common.cuh"
#include "red.cuh"

namespace {

__global__ void red_mark_kernel(const int* __restrict__ q_size,
                                const int* __restrict__ arrivals,
                                bool* __restrict__ mark,
                                int* __restrict__ admit,
                                int* __restrict__ trim,
                                int n, int cap, float kmin, float kmax,
                                uint32_t tick, uint32_t salt) {
    const int q = blockIdx.x * blockDim.x + threadIdx.x;
    if (q >= n) return;
    const int qs = q_size[q];
    const float span = fmax_t(kmax - kmin, 1e-6f);
    mark[q] = red_flip(qs, kmin, span, tick, (uint32_t)q, salt) && (qs > 0);
    const int space = cap - qs > 0 ? cap - qs : 0;
    const int a = arrivals[q];
    const int ad = a < space ? a : space;
    admit[q] = ad;
    trim[q] = a - ad;
}

}  // namespace

REPRO_EXPORT int repro_red_mark(const int* q_size, const int* arrivals,
                                bool* mark, int* admit, int* trim, int n,
                                int cap, float kmin, float kmax, int tick,
                                int salt, void* stream) {
    constexpr int kThreads = 256;
    if (n > 0) {
        red_mark_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                          (cudaStream_t)stream>>>(
            q_size, arrivals, mark, admit, trim, n, cap, kmin, kmax,
            (uint32_t)tick, (uint32_t)salt);
    }
    return (int)cudaGetLastError();
}
