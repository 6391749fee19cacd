// Sent-ring drain of the transport phase: the ACK frees its slot,
// trim-notified slots become lost, RTO timeouts fire with the
// spurious-retransmission audit, and the per-flow timeout, spurious and
// outstanding counts are reduced.
//
// Replaces the TPU kernel src/repro/kernels/ring_drain/kernel.py:56
// `ring_drain` (pl.pallas_call at :79), whose body is
// repro/kernels/ring_drain/ref.py:34 `ring_drain_ref`.
//
// Bound on an H100: memory.  It reads the three i32 [NF, W] ring planes
// (state, seq, send tick), the [NF, WW] loss words, the [NF, MAXW]
// dedupe bitmap and 10 B of per-flow scalars, and writes the i32 [NF, W]
// state plane and three i32 counts a flow: about 1.07 MB at perm_1024n_3t
// ([1024, 64]), or 0.32 us at 3.35 TB/s.
//
// Design: one block per flow row, threads over the W lanes (a loop when
// W exceeds the block).  The ACKed slot is found directly (the reference's
// one-hot any-reduce has exactly one candidate lane), the loss bit and the
// receiver's dedupe word are read per lane, and the three counts are
// reduced with warp shuffles and then across the block's warps in shared
// memory.  The counts are kept as three separate sums, so the reference's
// 10-bit packing (ref.py:91-98, exact only while W < 1024) is not needed:
// the same kernel is right for every W.
#include "common.cuh"

constexpr int kMaxWarps = 8;

__global__ void ring_drain_kernel(int t, const float* __restrict__ rto,
                                  const bool* __restrict__ started,
                                  const bool* __restrict__ has_ack,
                                  const int* __restrict__ ack_seq,
                                  const int* __restrict__ lbits, int lstride,
                                  const int* __restrict__ bitmap, int bstride,
                                  int maxw,
                                  const int* __restrict__ sent0,
                                  const int* __restrict__ sent1,
                                  const int* __restrict__ sent2,
                                  int w,
                                  int* __restrict__ state_out,
                                  int* __restrict__ n_to_out,
                                  int* __restrict__ spur_out,
                                  int* __restrict__ un_out) {
    const int f = blockIdx.x;
    const size_t base = (size_t)f * w;
    const float rto_f = rto[f];
    const bool start_f = started[f];
    const int aseq = ack_seq[f];
    const int aslot = floor_mod(aseq, w);
    // 1. the ACK frees its slot when the slot still holds that sequence
    const bool match = has_ack[f] && sent0[base + aslot] != 0 &&
                       sent1[base + aslot] == aseq;
    const int* lrow = lbits + (size_t)f * lstride;
    const int* brow = bitmap + (size_t)f * bstride;

    int n_to = 0, spur = 0, un = 0;
    for (int j = threadIdx.x; j < w; j += blockDim.x) {
        int state = (match && j == aslot) ? 0 : sent0[base + j];
        // 2. trim-notified packets -> lost (awaiting retransmission)
        const int bit = (lrow[j >> 5] >> (j & 31)) & 1;
        if (bit == 1 && state == 1) state = 3;
        // 3. timeouts, audited against the receiver's dedupe bitmap
        const int seq = sent1[base + j];
        const bool to_mask = (state == 1) &&
                             ((float)(t - sent2[base + j]) > rto_f) && start_f;
        const int word = floor_div(seq, 32);
        const int bm = (word >= 0 && word < maxw) ? brow[word] : 0;
        const bool already = ((bm >> floor_mod(seq, 32)) & 1) == 1;
        if (to_mask) state = 3;
        state_out[base + j] = state;
        n_to += to_mask ? 1 : 0;
        spur += (to_mask && already) ? 1 : 0;
        un += (state == 1) ? 1 : 0;
    }

    for (int off = 16; off > 0; off >>= 1) {
        n_to += __shfl_down_sync(0xffffffffu, n_to, off);
        spur += __shfl_down_sync(0xffffffffu, spur, off);
        un += __shfl_down_sync(0xffffffffu, un, off);
    }
    __shared__ int partial[3][kMaxWarps];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) {
        partial[0][warp] = n_to;
        partial[1][warp] = spur;
        partial[2][warp] = un;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        const int warps = blockDim.x >> 5;
        for (int k = 1; k < warps; ++k) {
            n_to += partial[0][k];
            spur += partial[1][k];
            un += partial[2][k];
        }
        n_to_out[f] = n_to;
        spur_out[f] = spur;
        un_out[f] = un;
    }
}

REPRO_EXPORT int repro_ring_drain(int t, const float* rto, const bool* started,
                                  const bool* has_ack, const int* ack_seq,
                                  const int* lbits, int lstride,
                                  const int* bitmap, int bstride, int maxw,
                                  const int* sent0, const int* sent1,
                                  const int* sent2, int f, int w,
                                  int* state, int* n_to, int* spur, int* un,
                                  void* stream) {
    int threads = ((w + 31) / 32) * 32;
    if (threads > kMaxWarps * 32) threads = kMaxWarps * 32;
    if (f > 0 && w > 0) {
        ring_drain_kernel<<<f, threads, 0, (cudaStream_t)stream>>>(
            t, rto, started, has_ack, ack_seq, lbits, lstride, bitmap, bstride,
            maxw, sent0, sent1, sent2, w, state, n_to, spur, un);
    }
    return (int)cudaGetLastError();
}
