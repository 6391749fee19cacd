// The control phase of the tick in one launch: ACK/trim/credit gather,
// the sent-ring drain, the RTO backoff, the per-flow event and, for
// SMaRTT, the window update, with the metric sums reduced per block.
//
// Replaces, fused, the TPU kernels src/repro/kernels/cc_update/kernel.py:60
// `cc_update` (pl.pallas_call at :98) and src/repro/kernels/ring_drain/
// kernel.py:56 `ring_drain` (pl.pallas_call at :79), and the ~60 small
// operations of transport.control around them.  Its plain version is
// repro_torch/kernels/control/ref.py `control_ref`.
//
// Bound on an H100: memory.  At perm_1024n_3t (NF = 1024, W = 64) it reads
// the three i32 sent-ring rows of every flow (768 KB), writes the state
// plane back (256 KB), and reads/writes the trim and credit slots, the
// per-flow constants and state, the SMaRTT planes and the event buffer
// (~0.3 MB more): ~1.3 MB, or ~0.4 us at 3.35 TB/s.  The split design
// spent ~60 launches a tick on it, each sending an intermediate through
// device memory.
//
// Design: one warp a flow, lanes over the W ring slots (a loop for any W),
// 8 flows a block, so a block reads 8 contiguous sent-ring rows and no
// intermediate leaves registers.  Every lane loads the flow's scalars (one
// broadcast each) and its first two ring slots together, so the ring loads
// overlap the ACK chain (dst -> ACK row -> matched slot); the matched slot
// belongs to another lane, so every lane reads it before any lane writes
// the row (__syncwarp).  The three
// counts are reduced with warp shuffles, the window update runs on lane 0
// (smartt.cuh, shared with cc_update.cu), lanes 0-11 store the event
// fields and `unacked`.  The four metric sums and the RTT histogram are
// reduced per block in shared memory and added with one integer atomicAdd
// a block and counter (integer sums do not depend on the order, so they
// stay bit-exact).  A receiver's ACK row is read by all its flows, so the
// last block to finish zeroes the ACK slot: each block counts itself done
// once it has read its rows, and the block that brings the count to the
// grid size clears the slot and resets the count (threadfence-reduction
// pattern).  The trim and credit rows are the flow's own and its warp
// zeroes them (the warp of flow NF zeroes the sentinel rows).  Lane 0
// loads its flow's SMaRTT state before the drain, so those loads overlap
// the ACK and ring loads.  Built with --fmad=false, every f32 result is
// bit-equal to the plain version.
//
// Lanes (lanes.cuh): one grid row a lane of the batch.  The block reads its
// lane's gate and tick and moves every pointer by its lane stride: the
// rings, the state, the counters, the event rows and the finished-block
// count one row a lane (so the last block *of the lane* zeroes its ACK
// slot), rto, the SMaRTT parameter row (the 13 scalars, read from the
// device) and the [3, nf] per-flow parameter plane per lane where a study
// sweeps them, the workload's constants shared.
#include <cstddef>

#include "lanes.cuh"
#include "smartt.cuh"

constexpr int kFlows = 8;           // flows (warps) a block
constexpr int kMaxBins = 64;        // RTT histogram bins
constexpr int kPer = 2;             // ring slots a lane holds at once

// rows of the event buffer (kernels/control/ref.py EVENT_FIELDS)
enum { EV_HAS, EV_ECN, EV_ENT, EV_RTT, EV_BYTES, EV_TRIMS, EV_TBYTES,
       EV_NTO, EV_TOBYTES, EV_UNACKED, EV_CREDIT };

struct ControlArgs {
    // per-flow constants
    const int *dst, *size, *t_start;
    const float *rto;
    const float *pf;            // [3, nf]: brtt, trtt, mi (SMaRTT only)
    const float *params;        // [13]: CCParamsC's scalars (SMaRTT only)
    // the control rings; slot t % r is read and then zeroed
    int *ack_ring;              // [r, n, 6]
    int *trim_ring;             // [r, nf + 1, 2 + ww]
    float *credit_ring;         // [r, nf + 1]
    // state, updated in place
    int *sent;                  // [3, nf + 1, w]; plane 0 written
    int *rto_backoff;           // [nf]
    float *unacked;             // [nf]
    // the SMaRTT planes of CCState (kernels/control/ref.py CC_PLANES)
    float *cwnd, *acked, *qa_end;
    bool *trigger_qa;
    float *bytes_to_ignore, *bytes_ignored, *fi_count;
    bool *fi_active;
    float *avg_wtd;
    int *ack_count;
    int *n_to, *spur, *n_ack, *rtt_hist;   // metric counters, added to
    int *ev;                    // [11, nf] event buffer
    unsigned int *blocks_done;  // finished blocks of this launch (0 between launches)
    const bool *done;           // [nf] (read)
    const int *bitmap;          // [nf + 1, maxw] receiver dedupe (read)
    long long ls[30];           // each pointer's lane stride, bytes
    int nf, n, r, w, ww, maxw, mtu, backoff_max, bins, trimming, credit;
    float mtu_f, hist_scale;
};

template <bool kSmartt>
__global__ void __launch_bounds__(kFlows * 32)
control_kernel(ControlArgs a0, const int* now, const bool* live) {
    const int ln = blockIdx.y;
    const bool go = live[ln];
    const int t = now[ln];  // both loads issued at once
    if (!go) return;  // the whole block: its lane is idle
    const ControlArgs a = at_lane<30>(a0, ln);
    const bool* __restrict__ done = a.done;
    const int* __restrict__ bitmap = a.bitmap;
    __shared__ int s_hist[kMaxBins];
    __shared__ int s_cnt[3][kFlows];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int f = blockIdx.x * kFlows + warp;
    for (int i = threadIdx.x; i < a.bins; i += blockDim.x) s_hist[i] = 0;
    __syncthreads();

    const int slot = floor_mod(t, a.r);
    const int row = 2 + a.ww;                 // trim-ring row: count, bytes, words
    int* trow = a.trim_ring + ((size_t)slot * (a.nf + 1) + f) * row;
    float* crow = a.credit_ring + (size_t)slot * (a.nf + 1) + f;
    int n_to = 0, spur = 0, un = 0;
    bool has = false;
    if (f < a.nf) {
        const int nf = a.nf;
        Flow s{};
        CCParamsC p{};
        float brtt = 0.0f, trtt = 0.0f, mi = 0.0f;
        if (kSmartt && lane == 0) {
            p = *reinterpret_cast<const CCParamsC*>(a.params);
            s = Flow{a.cwnd[f], a.acked[f], a.qa_end[f], a.bytes_to_ignore[f],
                     a.bytes_ignored[f], a.fi_count[f], a.avg_wtd[f],
                     a.trigger_qa[f], a.fi_active[f], a.ack_count[f]};
            brtt = a.pf[f];
            trtt = a.pf[nf + f];
            mi = a.pf[2 * nf + f];
        }
        // ---- the flow's sent-ring row: the first kPer * 32 slots are
        // loaded now, beside the ACK row, since they do not depend on it
        const size_t plane = (size_t)(a.nf + 1) * a.w;
        int* s0 = a.sent + (size_t)f * a.w;
        const int* s1 = s0 + plane;
        const int* s2 = s0 + 2 * plane;
        int v0[kPer], v1[kPer], v2[kPer], lw[kPer];
        auto load = [&](int j0) {
#pragma unroll
            for (int k = 0; k < kPer; ++k) {
                const int j = j0 + k * 32 + lane;
                const bool in = j < a.w;
                v0[k] = in ? s0[j] : 0;
                v1[k] = in ? s1[j] : 0;
                v2[k] = in ? s2[j] : 0;
                lw[k] = (in && a.trimming) ? trow[2 + (j >> 5)] : 0;
            }
        };
        load(0);

        // ---- this tick's ACK (the receiver's row must name this flow),
        // trim and credit rows
        const int* arow = a.ack_ring + ((size_t)slot * a.n + a.dst[f]) * 6;
        has = arow[0] == 1 && arow[1] == f;
        const int aseq = has ? arow[2] : 0;
        const bool ecn = has && arow[3] == 1;
        const int ent = has ? arow[4] : 0;
        const int ats = has ? arow[5] : 0;
        const float rtt = has ? (float)(t - ats) : 0.0f;
        int ab = a.size[f] - aseq * a.mtu;
        ab = ab < 0 ? 0 : (ab > a.mtu ? a.mtu : ab);
        const float ack_bytes = has ? (float)ab : 0.0f;
        const int trims = a.trimming ? trow[0] : 0;
        const float tbytes = a.trimming ? (float)trow[1] : 0.0f;
        const float cred = a.credit ? *crow : 0.0f;

        // ---- the sent-ring drain (ring_drain.cu, one warp for the row)
        const bool started = (t >= a.t_start[f]) && !done[f];
        int rb = a.rto_backoff[f];
        float rto = a.rto[f];
        if (a.backoff_max) rto = ldexpf(rto, rb < a.backoff_max ? rb : a.backoff_max);
        const int aslot = floor_mod(aseq, a.w);
        // 1. the ACK frees its slot when the slot still holds that sequence
        const bool match = has && s0[aslot] != 0 && s1[aslot] == aseq;
        const int* brow = bitmap + (size_t)f * a.maxw;
        __syncwarp();                          // s0[aslot] read by every lane
        for (int j0 = 0; j0 < a.w; j0 += kPer * 32) {
            if (j0) load(j0);
#pragma unroll
            for (int k = 0; k < kPer; ++k) {
                const int j = j0 + k * 32 + lane;
                if (j >= a.w) break;
                int state = (match && j == aslot) ? 0 : v0[k];
                // 2. trim-notified packets -> lost (awaiting retransmission)
                if (state == 1 && ((lw[k] >> (j & 31)) & 1)) state = 3;
                // 3. timeouts, audited against the receiver's dedupe bitmap
                const bool to_mask = (state == 1) &&
                                     ((float)(t - v2[k]) > rto) && started;
                if (to_mask) {
                    const int seq = v1[k];
                    const int word = floor_div(seq, 32);
                    const int bm = (word >= 0 && word < a.maxw) ? brow[word] : 0;
                    spur += ((bm >> floor_mod(seq, 32)) & 1) == 1 ? 1 : 0;
                    n_to += 1;
                    state = 3;
                }
                s0[j] = state;
                un += (state == 1) ? 1 : 0;
            }
        }
        for (int off = 16; off > 0; off >>= 1) {
            n_to += __shfl_xor_sync(0xffffffffu, n_to, off);
            spur += __shfl_xor_sync(0xffffffffu, spur, off);
            un += __shfl_xor_sync(0xffffffffu, un, off);
        }
        __syncwarp();                          // the trim row read by every lane
        if (a.trimming)
            for (int j = lane; j < row; j += 32) trow[j] = 0;

        // ---- capped exponential RTO backoff: bump on a tick that fired
        // timeouts, reset on any ACK (on a tick with both, the reset wins)
        if (a.backoff_max) {
            if (n_to > 0) rb = rb + 1 < a.backoff_max ? rb + 1 : a.backoff_max;
            if (has) rb = 0;
        }
        const float to_bytes = (float)n_to * a.mtu_f;
        const float unacked = (float)un * a.mtu_f;

        // ---- the event, one field a lane
        int* ev = a.ev;
        switch (lane) {
            case EV_HAS: reinterpret_cast<bool*>(ev + EV_HAS * nf)[f] = has; break;
            case EV_ECN: reinterpret_cast<bool*>(ev + EV_ECN * nf)[f] = ecn; break;
            case EV_ENT: ev[EV_ENT * nf + f] = ent; break;
            case EV_RTT: reinterpret_cast<float*>(ev)[EV_RTT * nf + f] = rtt; break;
            case EV_BYTES: reinterpret_cast<float*>(ev)[EV_BYTES * nf + f] = ack_bytes; break;
            case EV_TRIMS: ev[EV_TRIMS * nf + f] = trims; break;
            case EV_TBYTES: reinterpret_cast<float*>(ev)[EV_TBYTES * nf + f] = tbytes; break;
            case EV_NTO: ev[EV_NTO * nf + f] = n_to; break;
            case EV_TOBYTES: reinterpret_cast<float*>(ev)[EV_TOBYTES * nf + f] = to_bytes; break;
            case EV_UNACKED: reinterpret_cast<float*>(ev)[EV_UNACKED * nf + f] = unacked; break;
            case EV_CREDIT:
                reinterpret_cast<float*>(ev)[EV_CREDIT * nf + f] = cred;
                if (a.credit) *crow = 0.0f;
                break;
            case EV_CREDIT + 1: a.unacked[f] = unacked; break;
            case EV_CREDIT + 2: if (a.backoff_max) a.rto_backoff[f] = rb; break;
            default: break;
        }

        if (lane == 0) {
            // ---- SMaRTT (Alg. 1-3) on this flow's registers
            if (kSmartt) {
                const FlowEvent e{has, ecn, ack_bytes, rtt, tbytes, to_bytes,
                                  unacked, trims, n_to};
                smartt_flow(s, p, e, (float)t, brtt, trtt, mi);
                a.cwnd[f] = s.cwnd;
                a.acked[f] = s.acked;
                a.qa_end[f] = s.qa_end;
                a.bytes_to_ignore[f] = s.bti;
                a.bytes_ignored[f] = s.big;
                a.fi_count[f] = s.fic;
                a.avg_wtd[f] = s.avg;
                a.trigger_qa[f] = s.tq;
                a.fi_active[f] = s.fa;
                a.ack_count[f] = s.ack_count;
            }
            // ---- RTT histogram bin (8 bins a base RTT)
            if (has) {
                int b = (int)(rtt * a.hist_scale);
                b = b < 0 ? 0 : (b > a.bins - 1 ? a.bins - 1 : b);
                atomicAdd(&s_hist[b], 1);
            }
        }
    } else if (f == a.nf) {
        // the sentinel rows of the trim and credit slots
        if (a.trimming)
            for (int j = lane; j < row; j += 32) trow[j] = 0;
        if (a.credit && lane == 0) *crow = 0.0f;
    }

    // ---- block sums of the metric increments, one atomic a counter
    if (lane == 0) {
        s_cnt[0][warp] = n_to;
        s_cnt[1][warp] = spur;
        s_cnt[2][warp] = has ? 1 : 0;
    }
    __syncthreads();
    if (threadIdx.x < 3) {
        int sum = 0;
        for (int k = 0; k < kFlows; ++k) sum += s_cnt[threadIdx.x][k];
        int* counter = threadIdx.x == 0 ? a.n_to : (threadIdx.x == 1 ? a.spur : a.n_ack);
        if (sum) atomicAdd(counter, sum);
    }
    for (int i = threadIdx.x; i < a.bins; i += blockDim.x)
        if (s_hist[i]) atomicAdd(&a.rtt_hist[i], s_hist[i]);

    // ---- the last block to finish zeroes the ACK slot (every block has
    // read its ACK rows before it counts itself done)
    __shared__ bool last;
    if (threadIdx.x == 0) {
        __threadfence();
        last = atomicAdd(a.blocks_done, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (last) {
        int* acks = a.ack_ring + (size_t)slot * a.n * 6;
        for (int i = threadIdx.x; i < a.n * 6; i += blockDim.x) acks[i] = 0;
        if (threadIdx.x == 0) *a.blocks_done = 0u;
    }
}

REPRO_EXPORT int repro_control(const ControlArgs* a, const int* now, const bool* live,
                               int smartt, int lanes, void* stream) {
    static_assert(offsetof(ControlArgs, ls) == 30 * sizeof(void*), "30 pointers");
    static_assert(sizeof(CCParamsC) == 13 * sizeof(float), "13 scalars");
    const dim3 grid((a->nf + 1 + kFlows - 1) / kFlows, lanes);   // + the sentinel rows
    cudaStream_t s = (cudaStream_t)stream;
    if (a->bins < 1 || a->bins > kMaxBins || lanes < 1 || lanes > 65535)
        return (int)cudaErrorInvalidValue;
    if (smartt && !a->params) return (int)cudaErrorInvalidValue;
    if (smartt)
        control_kernel<true><<<grid, kFlows * 32, 0, s>>>(*a, now, live);
    else
        control_kernel<false><<<grid, kFlows * 32, 0, s>>>(*a, now, live);
    return (int)cudaGetLastError();
}
