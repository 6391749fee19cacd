// Per-row round-robin pick: the eligible slot with the smallest
// (slot - rr) mod kmax key, first index on ties, plus an any-eligible flag.
//
// Replaces the TPU kernel src/repro/kernels/enqueue_arb/kernel.py:91
// `rr_pick` (pl.pallas_call at :101), whose body is
// repro/kernels/enqueue_arb/ref.py:61 `rr_pick_ref`.
//
// Bound on an H100: memory, nominally.  It reads a bool [N, K] plane and
// an i32 [N] cursor and writes a bool and an i32 per row: about 18 KB at
// alltoall_3t ([512, 31]), or 0.005 us at 3.35 TB/s.  Launch latency sets
// its time.
//
// Design: one warp per row.  Each lane keys its slots, keeps the smallest
// (key, index) pair, and a shuffle reduction keeps the smallest pair of
// the warp, comparing keys first and indices second, so ties go to the
// first index as the reference's argmin does.  Ineligible slots take the
// key kmax + 1, so a row with nothing eligible picks index 0, as the
// reference does.
#include "common.cuh"

constexpr int kWarpsPerBlock = 4;

__global__ void rr_pick_kernel(const bool* __restrict__ elig,
                               const int* __restrict__ rr,
                               bool* __restrict__ has_out,
                               int* __restrict__ sel_out,
                               int n, int k, int kmax) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    if (row >= n) return;                    // whole warp leaves together
    const bool* e = elig + (size_t)row * k;
    const int cursor = rr[row];
    int best_key = kmax + 1, best_idx = k;   // above every real slot
    bool any = false;
    for (int j = lane; j < k; j += 32) {
        const bool ok = e[j];
        const int key = ok ? floor_mod(j - cursor, kmax) : kmax + 1;
        any = any || ok;
        if (key < best_key || (key == best_key && j < best_idx)) {
            best_key = key;
            best_idx = j;
        }
    }
    for (int off = 16; off > 0; off >>= 1) {
        const int ok_ = __shfl_down_sync(0xffffffffu, best_key, off);
        const int oi = __shfl_down_sync(0xffffffffu, best_idx, off);
        if (ok_ < best_key || (ok_ == best_key && oi < best_idx)) {
            best_key = ok_;
            best_idx = oi;
        }
    }
    any = __any_sync(0xffffffffu, any);
    if (lane == 0) {
        has_out[row] = any;
        sel_out[row] = best_idx < k ? best_idx : 0;
    }
}

REPRO_EXPORT int repro_rr_pick(const bool* elig, const int* rr, bool* has,
                               int* sel, int n, int k, int kmax,
                               void* stream) {
    const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    if (n > 0) {
        rr_pick_kernel<<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
            elig, rr, has, sel, n, k, kmax);
    }
    return (int)cudaGetLastError();
}
