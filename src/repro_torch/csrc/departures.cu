// The departures phase of the tick in one launch: for every fabric port
// its service period under the fault schedule, its head-of-line packet
// with the RED dequeue mark, the packet's next queue (the down table or
// the ECMP hash over the next switch's up ports), its row of the wire
// slot, its advanced head and size, and the blackholed count.
//
// Replaces, fused, the TPU kernel src/repro/kernels/red_mark/kernel.py:42
// `red_mark` (pl.pallas_call at :57), whose coin flip the tick applies at
// dequeue, and the ~150 small operations of fabric.departures around it
// (the uint32 hashes of the flip and of route_from_queue emulated in int64
// among them).  Its plain version is repro_torch/kernels/departures/ref.py
// `departures_ref` (and, in this kernel's own formulation,
// `departures_by_port`).
//
// Bound on an H100: memory, but only nominally.  A port reads its size and
// head, a busy port its head-of-line row, the flow's destination and its
// routing tables (and its fault tables under a schedule), and writes its
// 28-byte wire row, head and size: about 100 B a port, ~0.2 MB at
// perm_1024n_3t's 2304 ports, or ~0.05-0.1 us at 3.35 TB/s.  The work is
// a chain of dependent loads (size -> head -> the packet -> the flow's
// destination -> the tables), so launch and load latency set its time.
//
// Design: one thread a port.
//  * Faults: the thread evaluates faults.port_period for its own row: the
//    count of table times at or before tr = t - fault_start, the period of
//    the last such column, the flap override; the flap phase is a floor
//    modulus (tr - fl_start can be negative), and the degraded port serves
//    when t % period == 0 on the absolute tick.
//  * The flip is red.cuh's red_flip (shared with red_mark.cu) with the
//    run's kspan as its span, read from the device as the plain version
//    reads it; kmin, kspan, fault_start and the run's salt are read
//    through pointers, so the host never waits on the card for them.
//  * Routing as fabric.route_from_queue: down to q_dn_base + d / stride
//    (floor division), else up by hash2(ent, salt) % max(cnt, 1) taken
//    unsigned, as the reference takes it in uint32; -(d + 1) on the edge
//    ports.
//  * A port that does not emit writes zeros to its wire row (the arrivals
//    phase and fabric.horizon rely on valid = 0).
//  * The blackholed count is summed a block (__syncthreads_count) and
//    added once with an integer atomic (order-free).
//  * Lanes (lanes.cuh): one grid row a lane of the batch.  The block reads
//    its lane's gate and tick, derives the two wire slots from the tick,
//    and moves every pointer by its lane stride: the state and the counter
//    one row a lane, kmin, kspan and fault_start per lane where a study
//    sweeps them, the tables shared.
// Built with --fmad=false and without --use_fast_math: the one f32
// operation, the mark's quotient, is the IEEE divide of the plain version.
#include <cstddef>
#include <cstdint>

#include "common.cuh"
#include "hash.cuh"
#include "lanes.cuh"
#include "red.cuh"

constexpr int kThreads = 256;

struct DeparturesArgs {
    // state
    const int *q_fields;                    // [nq + 1, cap, 5]
    int *q_head, *q_size;                   // [nq + 1]; [0, nq) updated
    int *infl;                              // [l, ne, 7]; rows [0, nq) written
    int *n_black;                           // counter
    // device scalars
    const float *kmin, *kspan;
    const int *salt, *fault_start;
    // routing tables
    const int *dst;                         // [nf]
    const int *q_lo, *q_hi, *q_dn_base, *q_dn_stride, *q_up_base, *q_up_cnt;  // [nq]
    const long long *q_salt;                // [nq], a uint32 each
    const bool *edge_q;                     // [nq]
    // fault tables
    const int *ft_time, *ft_period;         // [nq, fkc]
    const int *fl_start, *fl_end, *fl_cycle, *fl_up, *fl_period;  // [nq]
    long long ls[25];                       // each pointer's lane stride, bytes
    int nq, cap, ne, nf, qe, fkc, fk, flapped, l, lat_core, lat_edge;
};

__global__ void __launch_bounds__(kThreads)
departures_kernel(DeparturesArgs a0, const int* now, const bool* live) {
    const int lane = blockIdx.y;
    const bool go = live[lane];
    const int t = now[lane];  // both loads issued at once
    if (!go) return;  // the whole block: its lane is idle
    const DeparturesArgs a = at_lane<25>(a0, lane);
    const int core_slot = floor_mod(t + a.lat_core, a.l);
    const int edge_slot = floor_mod(t + a.lat_edge, a.l);
    const int q = blockIdx.x * kThreads + threadIdx.x;
    bool dead = false;
    if (q < a.nq) {
        const int qs = a.q_size[q];
        bool active = qs > 0;
        int per = 1;
        if (a.fk || a.flapped) {
            const int tr = t - *a.fault_start;
            if (a.fk) {
                const int* times = a.ft_time + (size_t)q * a.fkc;
                int cnt = 0;
                for (int k = 0; k < a.fk; ++k) cnt += tr >= times[k];
                per = a.ft_period[(size_t)q * a.fkc + (cnt > 1 ? cnt - 1 : 0)];
            }
            if (a.flapped) {
                const int cyc = a.fl_cycle[q], start = a.fl_start[q];
                const int ph = floor_mod(tr - start, cyc > 1 ? cyc : 1);
                if (cyc > 0 && tr >= start && tr < a.fl_end[q] && ph >= a.fl_up[q])
                    per = a.fl_period[q];
            }
            if (per > 1) active = active && t % per == 0;
            dead = per == 0 && active;
        }
        int row[7] = {0, 0, 0, 0, 0, 0, 0};
        int head = 0;
        if (active) {
            head = a.q_head[q];
            if (!dead) {
                const int* hf = a.q_fields + ((size_t)q * a.cap + head) * 5;
                const int flow = hf[0], seq = hf[1], ent = hf[2], ts = hf[4];
                const bool mark = red_flip(qs, *a.kmin, *a.kspan, (uint32_t)t,
                                           (uint32_t)q, (uint32_t)*a.salt + 0xECDu);
                const int d = a.dst[flow < 0 ? 0 : (flow < a.nf ? flow : a.nf - 1)];
                int nxt;
                if (a.edge_q[q]) {
                    nxt = -(d + 1);
                } else if (d >= a.q_lo[q] && d < a.q_hi[q]) {
                    nxt = a.q_dn_base[q] + floor_div(d, a.q_dn_stride[q]);
                } else {
                    const int cnt = a.q_up_cnt[q];
                    const uint32_t h = hash2((uint32_t)ent, (uint32_t)a.q_salt[q]);
                    nxt = a.q_up_base[q] + (int)(h % (uint32_t)(cnt > 1 ? cnt : 1));
                }
                row[0] = 1;
                row[1] = nxt;
                row[2] = flow;
                row[3] = seq;
                row[4] = ent;
                row[5] = hf[3] | (int)mark;
                row[6] = ts;
            }
        }
        const int slot = q < a.qe ? core_slot : edge_slot;
        int* w = a.infl + ((size_t)slot * a.ne + q) * 7;
#pragma unroll
        for (int c = 0; c < 7; ++c) w[c] = row[c];
        if (active) {
            a.q_head[q] = floor_mod(head + 1, a.cap);
            a.q_size[q] = qs - 1;
        }
    }
    const int n = __syncthreads_count(dead);
    if (threadIdx.x == 0 && n) atomicAdd(a.n_black, n);
}

REPRO_EXPORT int repro_departures(const DeparturesArgs* a, const int* now, const bool* live,
                                  int lanes, void* stream) {
    static_assert(offsetof(DeparturesArgs, ls) == 25 * sizeof(void*), "25 pointers");
    if (a->l < 1 || lanes < 1 || lanes > 65535) return (int)cudaErrorInvalidValue;
    if (a->nq > 0) {
        const dim3 grid((a->nq + kThreads - 1) / kThreads, lanes);
        departures_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(*a, now, live);
    }
    return (int)cudaGetLastError();
}
