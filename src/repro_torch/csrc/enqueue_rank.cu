// Same-destination enqueue rank, acceptance and ring slot for every slot
// of every switch fan-in group row.
//
// Replaces the TPU kernel src/repro/kernels/enqueue_arb/kernel.py:56
// `enqueue_rank` (pl.pallas_call at :67), whose body is
// repro/kernels/enqueue_arb/ref.py:36 `enqueue_rank_ref`.
//
// Bound on an H100: memory, but only nominally.  It reads three i32
// [NSW, DMAX] planes and writes two i32 and one bool plane: 21 B a slot,
// about 74 KB at perm_1024n_3t ([176, 20]), or 0.02 us at 3.35 TB/s; the
// DMAX^2 / 2 compares a row (about 35 K integer operations in all) are
// nothing beside that.  Launch latency sets its time.
//
// Design: one block per switch row, one thread per slot.  A slot's rank
// is the count of lower slots of its row with the same destination,
// which the thread counts in a loop over the row (the row is read from
// L1).  The Pallas lane padding is not copied; the sentinel destination
// `nq` ("no enqueue") stays and is never accepted.
#include "common.cuh"

__global__ void enqueue_rank_kernel(const int* __restrict__ gdst,
                                    const int* __restrict__ ghead,
                                    const int* __restrict__ gsize,
                                    int* __restrict__ rank_out,
                                    bool* __restrict__ acc_out,
                                    int* __restrict__ pos_out,
                                    int d, int cap, int nq) {
    const int* row = gdst + (size_t)blockIdx.x * d;
    for (int j = threadIdx.x; j < d; j += blockDim.x) {
        const size_t at = (size_t)blockIdx.x * d + j;
        const int g = row[j];
        int rank = 0;
        for (int k = 0; k < j; ++k) rank += (row[k] == g) ? 1 : 0;
        const int size = gsize[at];
        rank_out[at] = rank;
        acc_out[at] = (g < nq) && (rank < cap - size);
        pos_out[at] = floor_mod(ghead[at] + size + rank, cap);
    }
}

REPRO_EXPORT int repro_enqueue_rank(const int* gdst, const int* ghead,
                                    const int* gsize, int* rank, bool* acc,
                                    int* pos, int s, int d, int cap, int nq,
                                    void* stream) {
    int threads = ((d + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    if (s > 0 && d > 0) {
        enqueue_rank_kernel<<<s, threads, 0, (cudaStream_t)stream>>>(
            gdst, ghead, gsize, rank, acc, pos, d, cap, nq);
    }
    return (int)cudaGetLastError();
}
