// The sends phase of the tick in one launch: every flow's admission
// (activation, the dependency gate, the windowed count of unfinished
// predecessors, the first pending retransmission or the next new
// sequence, the window, credit and pacing gates), one packet a sender by
// round-robin pick over its row of flows_of, and the winner's emission
// (entropy by the load balancer, first hop by the ECMP hash, its NIC row
// of the wire slot, its sent-ring slot, next sequence, LB counters,
// credits and pacing budget), plus the retransmission count.
//
// Replaces, fused, the TPU kernel src/repro/kernels/enqueue_arb/kernel.py:91
// `rr_pick` (pl.pallas_call at :101) at its sends call site and the ~100
// small operations of sender.sends around it.  Its plain version is
// repro_torch/kernels/sends/ref.py `sends_ref` (and, in this kernel's own
// formulation, `sends_by_sender`).
//
// Bound on an H100: memory, but only nominally.  At perm_1024n_3t the
// phase must read a few words a flow (its row slot, start, done, window,
// the next sequence and its ring slot, a started flow's ring state plane)
// and write back the ~1000 NIC rows and the emitted packets' ring slots
// and counters: tens of KB, or ~0.02-0.05 us at 3.35 TB/s.  The work is a
// chain of dependent loads (flows_of -> the flow's words -> its ring ->
// the winner's hash and writes), so launch and load latency set its time.
// The split design spent ~100 launches a tick on it.
//
// Design: one warp a sender row of flows_of (8 warps a block), the lanes
// taking the row's slots 32 at a time.
//  * Admission a lane a flow.  The windowed count: __ballot_sync of the
//    unfinished flows and __popc of the lower lanes, plus the count carried
//    from the row's earlier chunks.  The retransmission scan: for each
//    started flow of the chunk (the set bits of a ballot), the warp reads
//    its ring's state words 32 at a time (coalesced), and __ffs of the
//    ballot of "== 3" gives the first pending slot.
//  * Pick: the key floor_mod(slot - rr_send, FMAX), FMAX + 1 where the
//    slot is not eligible.  Each lane keeps its least (key, slot) across
//    the chunks (its slots rise, so a tie keeps the first), and a butterfly
//    of shuffles gives every lane the warp's least (key, slot), comparing
//    keys first and slots second as rr_pick.cu does: ties go to the first
//    index, as the reference's argmin.  rr_send moves past the pick where
//    a slot was picked and FMAX > 1 (for FMAX = 1 the pick is the identity
//    and the cursor is left alone, as the reference does).
//  * Emission by the winning lane alone: it holds its flow's admission
//    results in registers.  Entropy by lb_mode (core/reps.py on_send), the
//    first hop (fabric.route_first_hop) with the splitmix32 hash in native
//    uint32 (hash.cuh), % max(cnt, 1) taken unsigned as the reference
//    takes it in uint32.  A sender with nothing to send writes its NIC row
//    as zeros (the arrivals phase and fabric.horizon rely on valid = 0).
//  * Pacing: every flow of the row gets its accrued budget written,
//    emitting or not; the winner then pays its packet.
//  * The retransmission count is summed a block (__syncthreads_count) and
//    added once with an integer atomic (order-free).
//  * Lanes (lanes.cuh): one grid row a lane of the batch.  The block reads
//    its lane's gate and tick, derives the wire slot from the tick, and
//    moves every pointer of both argument structs by its lane stride (the
//    state one row a lane, num_entropies per lane where a study sweeps it,
//    the workload's tables shared).
// Built with --fmad=false: the f32 work is single adds, subtracts and
// compares, as in the plain version, so every result is bit-equal.
#include <cstddef>
#include <cstdint>

#include "hash.cuh"
#include "lanes.cuh"

constexpr int kWarps = 8;                  // sender rows a block
constexpr unsigned kFull = 0xffffffffu;

enum LbMode { kReps = 0, kSpray = 1, kEcmp = 2, kPlb = 3 };

struct SendsArgs {
    // run constants
    const int *src, *t_start, *size;        // [nf]
    const int *dep_par, *dep_thr;           // [nf, d]
    const int *flows_of;                    // [n, fmax], padded with nf
    const bool *f_down;                     // [nf]
    const int *f_dn_q, *f_up_base, *f_up_cnt;   // [nf]
    const long long *f_salt;                // [nf], a uint32 each
    const int *num_entropies, *bdp_pkts;    // device scalars
    // state the phase reads
    const bool *done;                       // [nf]
    const int *goodput;                     // [nf]
    // state updated in place
    int *sent;                              // [3, nf + 1, w]
    int *infl;                              // [l, ne, 7]; NIC rows of slot `wire`
    int *next_seq, *rr_send;                // [nf], [n]
    float *pace_accum;                      // [nf]
    int *explore_sent, *spray_ctr;          // [nf]
    int *n_retx;                            // counter
    long long ls[23];                       // each pointer's lane stride, bytes
    int nf, n, fmax, d, w, ne, nq, window, credit, paced, lb_mode, mtu, l, lat_send;
};

// The operands earlier phases replace each tick (passed every launch).
struct SendsTick {
    const float *unacked, *cwnd, *pacing_rate;  // [nf]
    float *credits, *spec_budget;               // [nf]
    int *next_entropy;                          // [nf]
    const int *cached_entropy, *plb_entropy;    // [nf]
    long long ls[8];                            // each pointer's lane stride, bytes
};

// i32 product with the reference's wrap.
__device__ __forceinline__ int mul_wrap(int a, int b) {
    return (int)((unsigned)a * (unsigned)b);
}

__global__ void __launch_bounds__(kWarps * 32)
sends_kernel(SendsArgs a0, SendsTick k0, const int* now, const bool* live) {
    const int ln = blockIdx.y;
    const bool go = live[ln];
    const int t = now[ln];  // both loads issued at once
    if (!go) return;  // the whole block: its lane is idle
    const SendsArgs a = at_lane<23>(a0, ln);
    const SendsTick k = at_lane<8>(k0, ln);
    const int wire = floor_mod(t + a.lat_send, a.l);
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
    const bool live_row = row < a.n;         // warp-uniform
    bool retx_sent = false;
    if (live_row) {
        const int fmax = a.fmax;
        const int rr = a.rr_send[row];
        const bool windowed = a.window < fmax;
        const float pace_cap = 4.0f * (float)a.mtu;
        int carry = 0;                       // unfinished flows in earlier chunks
        int best_key = fmax + 1, best_col = 0x7fffffff, best_f = 0, best_seq = 0;
        bool best_retx = false;
        float best_nsize = 0.0f;
        for (int c0 = 0; c0 < fmax; c0 += 32) {
            const int col = c0 + lane;
            const int f = col < fmax ? a.flows_of[(size_t)row * fmax + col] : a.nf;
            const bool real = (unsigned)f < (unsigned)a.nf;
            const bool done = real ? a.done[f] : true;
            bool started = real && t >= a.t_start[f] && !done;
            for (int j = 0; started && j < a.d; ++j) {
                const int p = a.dep_par[(size_t)f * a.d + j];
                started = p == a.nf || a.goodput[p] >= a.dep_thr[(size_t)f * a.d + j];
            }
            if (windowed) {
                const unsigned unfin = __ballot_sync(kFull, real && !done);
                started = started && carry + __popc(unfin & ((1u << lane) - 1u)) < a.window;
                carry += __popc(unfin);
            }
            // the first pending retransmission of each started flow, the
            // warp reading its ring's state words 32 at a time
            bool has_retx = false;
            int rslot = 0;
            for (unsigned todo = __ballot_sync(kFull, started); todo; todo &= todo - 1) {
                const int owner = __ffs(todo) - 1;
                const int* ring = a.sent + (size_t)__shfl_sync(kFull, f, owner) * a.w;
                int found = -1;                  // warp-uniform
                for (int b0 = 0; b0 < a.w && found < 0; b0 += 32) {
                    const unsigned m = __ballot_sync(
                        kFull, b0 + lane < a.w && ring[b0 + lane] == 3);
                    if (m) found = b0 + __ffs(m) - 1;
                }
                if (lane == owner && found >= 0) {
                    has_retx = true;
                    rslot = found;
                }
            }
            int seq = 0;
            float nsize = 0.0f;
            bool elig = false;
            if (started) {
                const int ns = a.next_seq[f], sz = a.size[f];
                const int* s0 = a.sent + (size_t)f * a.w;
                const int* s1 = a.sent + ((size_t)(a.nf + 1) + f) * a.w;
                const bool new_ok = mul_wrap(ns, a.mtu) < sz && s0[floor_mod(ns, a.w)] == 0;
                seq = has_retx ? s1[rslot] : ns;
                const int rem = sz - mul_wrap(seq, a.mtu);
                nsize = (float)(rem < 0 ? 0 : (rem > a.mtu ? a.mtu : rem));
                elig = (has_retx || new_ok) && k.unacked[f] + nsize <= k.cwnd[f] && nsize > 0.0f;
                if (a.credit) elig = elig && (k.credits[f] >= nsize || k.spec_budget[f] >= nsize);
            }
            if (a.paced && real) {               // every flow's budget accrues
                float pace = a.pace_accum[f] + k.pacing_rate[f];
                pace = pace > pace_cap ? pace_cap : pace;
                a.pace_accum[f] = pace;
                elig = elig && pace >= nsize;
            }
            const int key = elig ? floor_mod(col - rr, fmax) : fmax + 1;
            if (key < best_key) {                // a lane's slots rise: ties keep the first
                best_key = key;
                best_col = col;
                best_f = f;
                best_seq = seq;
                best_retx = has_retx;
                best_nsize = nsize;
            }
        }
        // the warp's least (key, slot), on every lane
        int wk = best_key, wc = best_col;
        for (int off = 16; off > 0; off >>= 1) {
            const int ok = __shfl_xor_sync(kFull, wk, off);
            const int oc = __shfl_xor_sync(kFull, wc, off);
            if (ok < wk || (ok == wk && oc < wc)) {
                wk = ok;
                wc = oc;
            }
        }
        const bool has_s = wk <= fmax;
        int* nic = a.infl + ((size_t)wire * a.ne + a.nq + row) * 7;
        if (has_s && best_key == wk && best_col == wc) {     // the winner emits
            const int f = best_f, seq = best_seq;
            const int n = *a.num_entropies;
            int ent;
            switch (a.lb_mode) {
            case kReps: {
                const bool explore = seq < *a.bdp_pkts && a.explore_sent[f] < n;
                ent = floor_mod(explore ? k.next_entropy[f] : k.cached_entropy[f], n);
                if (explore) {
                    k.next_entropy[f] += 1;
                    a.explore_sent[f] += 1;
                }
                break;
            }
            case kSpray:
                ent = (int)(hash2(hash2((uint32_t)f, (uint32_t)a.spray_ctr[f]), 0x5E4Au)
                            % (uint32_t)n);
                a.spray_ctr[f] += 1;
                break;
            case kEcmp:
                ent = floor_mod(f, n);
                break;
            default:
                ent = floor_mod(k.plb_entropy[f], n);
                break;
            }
            int q = a.f_dn_q[f];
            if (!a.f_down[f]) {
                const int cnt = a.f_up_cnt[f];
                q = a.f_up_base[f] + (int)(hash2((uint32_t)ent, (uint32_t)a.f_salt[f])
                                           % (uint32_t)(cnt > 1 ? cnt : 1));
            }
            nic[0] = 1;
            nic[1] = q;
            nic[2] = f;
            nic[3] = seq;
            nic[4] = ent;
            nic[5] = 0;
            nic[6] = t;
            const size_t plane = (size_t)(a.nf + 1) * a.w;
            int* slot = a.sent + (size_t)f * a.w + floor_mod(seq, a.w);
            slot[0] = 1;
            slot[plane] = seq;
            slot[2 * plane] = t;
            if (!best_retx) a.next_seq[f] += 1;
            retx_sent = best_retx;
            if (a.credit) {
                if (k.credits[f] >= best_nsize)
                    k.credits[f] = k.credits[f] - best_nsize;
                else
                    k.spec_budget[f] = k.spec_budget[f] - best_nsize;
            }
            if (a.paced) a.pace_accum[f] = a.pace_accum[f] - best_nsize;
        } else if (!has_s && lane < 7) {
            nic[lane] = 0;                       // an idle NIC
        }
        if (has_s && fmax > 1 && lane == 0) a.rr_send[row] = floor_mod(wc + 1, fmax);
    }
    const int n_retx = __syncthreads_count(retx_sent);
    if (threadIdx.x == 0 && n_retx) atomicAdd(a.n_retx, n_retx);
}

REPRO_EXPORT int repro_sends(const SendsArgs* a, const SendsTick* k, const int* now,
                             const bool* live, int lanes, void* stream) {
    static_assert(offsetof(SendsArgs, ls) == 23 * sizeof(void*), "23 pointers");
    static_assert(offsetof(SendsTick, ls) == 8 * sizeof(void*), "8 pointers");
    if (a->n < 1 || a->fmax < 1 || a->w < 1 || a->lb_mode < kReps || a->lb_mode > kPlb
        || a->l < 1 || lanes < 1 || lanes > 65535)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((a->n + kWarps - 1) / kWarps, lanes);
    sends_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(*a, *k, now, live);
    return (int)cudaGetLastError();
}
