// The arrivals phase of the tick in one launch: the wire slot landing now
// is read and zeroed, packets are enqueued mid-fabric (same-destination
// rank, acceptance, ring slot, the queues' sizes; rejects trimmed into the
// delayed trim ledger or dropped) or delivered at the edge (ACK row,
// receiver dedupe bitmap, goodput, done, fct), and the metrics are added.
//
// Replaces, fused, the TPU kernel src/repro/kernels/enqueue_arb/kernel.py:56
// `enqueue_rank` (pl.pallas_call at :67) and the ~50 small operations of
// fabric.arrivals around it.  Its plain version is
// repro_torch/kernels/arrivals/ref.py `arrivals_ref` (and, in this
// kernel's own formulation, `arrivals_by_owner`).
//
// Bound on an H100: memory, but only nominally.  At perm_1024n_3t the
// phase must read the wire slot ([3328, 7] i32, 93 KB) and the fan-in
// tables (~23 KB), and write back only the ~120 rows that hold a packet
// and a few words a packet: ~0.12 MB, or ~0.04 us at 3.35 TB/s (this
// kernel zeroes every row of the slot, held or not).  The work is a chain
// of dependent loads (in_tbl -> enq_ids -> the wire row -> q_size), so
// launch and load latency set its time.  The split design spent ~50
// launches a tick on it, each sending an intermediate through memory.
//
// Design: one grid, two roles.
//  * Blocks [0, nsw): one block a switch fan-in row in_tbl[sw], one thread
//    a slot.  A slot reads its emitter's wire row once and zeroes it (the
//    rows of a slot are the wire rows of the enqueue-capable emitters, each
//    named once).  Same-destination ranks: __match_any_sync and __popc of
//    the lower lanes, plus a carry counted from shared memory over the
//    lower warps when the row spans several.  Every writer into queue q
//    sits in q's switch's row, so the block owns its queues: it reads
//    their q_size / q_head, synchronizes, and then the last slot of each
//    destination writes its queue's new size (no atomics).  Accepted
//    packets go straight into q_fields; a reject adds its count, bytes
//    and loss-word bit to the trim ledger with integer atomics (order-free;
//    bit 31 wraps to -2**31 as in the reference) and, on the credit path,
//    its bytes to a per-flow integer staging row.
//  * Blocks [nsw, ...): one thread a node.  It reads its delivery row
//    (QE + node) and zeroes it, writes its ACK row whole, and where the
//    row delivers a flow whose destination is this node (the flow is then
//    updated by no other thread), its bitmap word, goodput, done and fct.
//  * Integer counters are summed a warp and added with atomics.  The f32
//    metrics (delivered bytes, the goodput bin, bytes while faulted) and
//    trim_seen get one f32 add each of the tick's integer total, by the
//    last block to finish (a count of finished blocks, threadfence
//    reduction), which also resets the scratch row.  Built with
//    --fmad=false; every result is bit-equal to the plain version.
//  * Lanes (lanes.cuh): one grid row a lane of the batch.  The block reads
//    its lane's gate and tick, derives the wire, ACK and trim slots, the
//    goodput bin and the fct base from the tick, and moves every pointer
//    by its lane stride (the goodput bin width per lane where a study
//    sweeps it).  The scratch row and so the count of finished blocks are
//    per lane: the last block of its own lane adds that lane's totals.
#include <cstddef>

#include "lanes.cuh"

constexpr int kMaxRow = 1024;       // fan-in slots a row (threads a block)

struct ArrivalsArgs {
    // run constants
    const int *enq_ids;         // [eq] enqueue-capable emitter ids
    const int *in_tbl;          // [nsw, d] compact indices, padded with eq
    const int *dst, *size, *t_start;   // [nf]
    // state, updated in place
    int *infl;                  // [l, ne, 7]; slot `wire` read, then zeroed
    int *q_fields;              // [nq + 1, cap, 5]
    const int *q_head;          // [nq + 1] (read)
    int *q_size;                // [nq + 1]
    int *ack_ring;              // [r, n, 6]; slot `ack` written whole
    int *trim_ring;             // [r, nf + 1, 2 + ww]; slot `trim` added to
    float *trim_seen;           // [nf + 1]
    int *bitmap;                // [nf + 1, maxw]
    int *goodput;               // [nf]
    bool *done;                 // [nf]
    int *fct;                   // [nf]
    int *delivered_pkts, *n_rej;        // i32 counters (n_rej: n_trim or n_drop)
    float *delivered_bytes, *goodput_hist, *delivered_bytes_fault;
    int *scratch;               // [2 + nf + 1]: finished blocks, the tick's
                                // delivered bytes, trim_seen staging; zero
                                // between launches
    const int *goodput_bin;     // ticks a goodput_hist bin
    long long ls[23];           // each pointer's lane stride, bytes
    int nsw, d, eq, ne, nq, qe, n, nf, cap, ww, maxw, mtu, trimming, credit, faulty;
    int l, r, ret, trim_delay;
};

// The wire size of packet `seq` of a flow of `size` bytes (i32 wrap as in
// the reference).
__device__ __forceinline__ int pkt_bytes(int size, int seq, int mtu) {
    const int rem = size - (int)((unsigned)seq * (unsigned)mtu);
    return rem < 0 ? 0 : (rem > mtu ? mtu : rem);
}

__device__ __forceinline__ void enqueue_row(const ArrivalsArgs& a, int wire, int tslot) {
    __shared__ int s_key[kMaxRow];
    const int sw = blockIdx.x, j = threadIdx.x;
    const int lane = j & 31, warp = j >> 5;
    const int c = j < a.d ? a.in_tbl[(size_t)sw * a.d + j] : a.eq;
    int v[7] = {0, 0, 0, 0, 0, 0, 0};
    if (c < a.eq) {
        int* row = a.infl + ((size_t)wire * a.ne + a.enq_ids[c]) * 7;
#pragma unroll
        for (int k = 0; k < 7; ++k) v[k] = row[k];
#pragma unroll
        for (int k = 0; k < 7; ++k) row[k] = 0;
    }
    const int g = (v[0] == 1 && v[1] >= 0) ? v[1] : a.nq;   // nq: no enqueue
    const int key = j < a.d ? g : -1;                        // lanes past the row
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    int rank = __popc(peers & ((1u << lane) - 1u));
    bool last = (peers >> lane) == 1u;          // no higher lane shares the key
    if (blockDim.x > 32) {                      // the carry across warps
        s_key[j] = key;
        __syncthreads();
        for (int k = 0; k < warp * 32; ++k) rank += s_key[k] == key;
        for (int k = (warp + 1) * 32; k < a.d; ++k) last = last && s_key[k] != key;
    }
    const bool live = g < a.nq;
    int size = 0, head = 0;
    if (live) {
        size = a.q_size[g];
        head = a.q_head[g];
    }
    __syncthreads();                            // every q_size read before a write
    const bool acc = live && rank < a.cap - size;
    const bool rej = live && !acc;
    if (acc) {
        int* qf = a.q_fields + ((size_t)g * a.cap + floor_mod(head + size + rank, a.cap)) * 5;
#pragma unroll
        for (int k = 0; k < 5; ++k) qf[k] = v[2 + k];
    }
    if (live && last) {                         // the queue's new size
        const int space = a.cap - size > 0 ? a.cap - size : 0;
        const int count = rank + 1 < space ? rank + 1 : space;
        if (count) a.q_size[g] = size + count;
    }
    if (rej) {
        const int f = v[2], seq = v[3];
        const int fc = f < 0 ? 0 : (f > a.nf - 1 ? a.nf - 1 : f);
        const int bytes = pkt_bytes(a.size[fc], seq, a.mtu);
        if ((unsigned)f <= (unsigned)a.nf) {
            if (a.trimming) {
                int* tr = a.trim_ring + ((size_t)tslot * (a.nf + 1) + f) * (2 + a.ww);
                const int m = floor_mod(seq, 32 * a.ww);
                atomicAdd(tr, 1);
                if (bytes) atomicAdd(tr + 1, bytes);
                atomicAdd(tr + 2 + (m >> 5), (int)(1u << (m & 31)));
            }
            if (a.credit && bytes) atomicAdd(a.scratch + 2 + f, bytes);
        }
    }
    const int n_rej = __popc(__ballot_sync(0xffffffffu, rej));
    if (lane == 0 && n_rej) atomicAdd(a.n_rej, n_rej);
}

__device__ __forceinline__ void deliver_nodes(const ArrivalsArgs& a, int wire, int aslot, int fct_base) {
    const int i = (blockIdx.x - a.nsw) * blockDim.x + threadIdx.x;
    bool deliver = false;
    int bytes = 0;
    if (i < a.n) {
        int* row = a.infl + ((size_t)wire * a.ne + a.qe + i) * 7;
        int v[7];
#pragma unroll
        for (int k = 0; k < 7; ++k) v[k] = row[k];
#pragma unroll
        for (int k = 0; k < 7; ++k) row[k] = 0;
        deliver = v[0] == 1 && v[1] < 0;
        // the ACK row (valid, flow, seq, ecn, ent, ts), zeros for no delivery
        int* ack = a.ack_ring + ((size_t)aslot * a.n + i) * 6;
        ack[0] = deliver ? 1 : 0;
        ack[1] = deliver ? v[2] : 0;
        ack[2] = deliver ? v[3] : 0;
        ack[3] = deliver ? v[5] : 0;
        ack[4] = deliver ? v[4] : 0;
        ack[5] = deliver ? v[6] : 0;
        const int f = v[2];
        if (deliver && f >= 0 && f < a.nf && a.dst[f] == i) {
            const int seq = v[3];
            const int word = floor_div(seq, 32), bit = floor_mod(seq, 32);
            const bool in = word >= 0 && word < a.maxw;
            int* bw = in ? a.bitmap + (size_t)f * a.maxw + word : nullptr;
            const int old = in ? *bw : 0;
            const int fsize = a.size[f];
            int gp = a.goodput[f];
            if (((old >> bit) & 1) == 0) {      // a new packet
                if (in) *bw = old + (int)(1u << bit);
                bytes = pkt_bytes(fsize, seq, a.mtu);
                gp += bytes;
                a.goodput[f] = gp;
            }
            if (gp >= fsize && !a.done[f]) {
                a.done[f] = true;
                a.fct[f] = fct_base - a.t_start[f];
            }
        }
    }
    const int n_del = __popc(__ballot_sync(0xffffffffu, deliver));
    bytes = __reduce_add_sync(0xffffffffu, bytes);
    if ((threadIdx.x & 31) == 0) {
        if (n_del) atomicAdd(a.delivered_pkts, n_del);
        if (bytes) atomicAdd(a.scratch + 1, bytes);
    }
}

__global__ void __launch_bounds__(kMaxRow)
arrivals_kernel(ArrivalsArgs a0, const int* now, const bool* live,
                const bool* fault_active) {
    const int lane = blockIdx.y;
    const bool go = live[lane];
    const int t = now[lane];  // both loads issued at once
    if (!go) return;  // the whole block: its lane is idle
    const ArrivalsArgs a = at_lane<23>(a0, lane);
    const int wire = floor_mod(t, a.l);
    const int aslot = floor_mod(t + a.ret, a.r), tslot = floor_mod(t + a.trim_delay, a.r);
    const int fct_base = t + a.ret;
    if (blockIdx.x < a.nsw)
        enqueue_row(a, wire, tslot);
    else
        deliver_nodes(a, wire, aslot, fct_base);

    // ---- the last block to finish adds the f32 metrics' integer totals
    // (every block's atomics are done before it counts itself finished)
    __shared__ bool last;
    __syncthreads();
    if (threadIdx.x == 0) {
        __threadfence();
        last = atomicAdd(reinterpret_cast<unsigned*>(a.scratch), 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return;
    if (threadIdx.x == 0) {
        const float db = (float)atomicExch(a.scratch + 1, 0);
        *a.delivered_bytes = *a.delivered_bytes + db;
        if (a.faulty) {
            const int gb = t / *a.goodput_bin;
            const int gbin = gb < 63 ? gb : 63;     // GOODPUT_BINS - 1
            a.goodput_hist[gbin] = a.goodput_hist[gbin] + db;
            if (fault_active[lane]) *a.delivered_bytes_fault = *a.delivered_bytes_fault + db;
        }
        a.scratch[0] = 0;
    }
    if (a.credit)
        for (int f = threadIdx.x; f <= a.nf; f += blockDim.x) {
            const int b = atomicExch(a.scratch + 2 + f, 0);
            if (b) a.trim_seen[f] = a.trim_seen[f] + (float)b;
        }
}

REPRO_EXPORT int repro_arrivals(const ArrivalsArgs* a, const int* now, const bool* live,
                                const bool* fault_active, int lanes, void* stream) {
    static_assert(offsetof(ArrivalsArgs, ls) == 23 * sizeof(void*), "23 pointers");
    if (a->d < 1 || a->d > kMaxRow || (a->faulty && !fault_active) || a->l < 1 || a->r < 1
        || lanes < 1 || lanes > 65535)
        return (int)cudaErrorInvalidValue;
    const int threads = ((a->d + 31) / 32) * 32;
    const dim3 grid(a->nsw + (a->n + threads - 1) / threads, lanes);
    arrivals_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(*a, now, live, fault_active);
    return (int)cudaGetLastError();
}
