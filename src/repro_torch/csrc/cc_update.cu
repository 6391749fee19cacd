// SMaRTT per-flow congestion-window update (paper Alg. 1-3), one thread
// per flow over the structure-of-arrays state planes.
//
// Replaces the TPU kernel src/repro/kernels/cc_update/kernel.py:60
// `cc_update` (pl.pallas_call at :98), whose body is
// repro/core/smartt.py:64 `smartt_update`.
//
// Bound on an H100: memory.  Per flow it reads 7 f32 + 2 bool + 1 i32
// state, 5 f32 + 2 bool + 2 i32 events and 3 f32 per-flow parameters
// (76 B) and writes the 10 state planes back (34 B): 110 B a flow, about
// 113 KB at perm_1024n_3t (NF = 1024), or 0.034 us at 3.35 TB/s.  A launch
// costs microseconds, so launch latency, not the bound, sets its time.
//
// Design: the update itself is `smartt_flow` of smartt.cuh, which the
// fused control phase (control.cu) runs too; this kernel loads a flow's
// planes, calls it, and stores the planes back.
#include "smartt.cuh"

struct CCArgs {
    // state in
    const float *cwnd, *acked, *qa_end, *bytes_to_ignore, *bytes_ignored,
        *fi_count, *avg_wtd;
    const bool *trigger_qa, *fi_active;
    const int *ack_count;
    // events in
    const float *ack_bytes, *rtt, *trim_bytes, *to_bytes, *unacked;
    const bool *has_ack, *ecn;
    const int *n_trims, *n_timeouts;
    // per-flow parameters
    const float *brtt, *trtt, *mi;
    // state out
    float *o_cwnd, *o_acked, *o_qa_end, *o_bytes_to_ignore, *o_bytes_ignored,
        *o_fi_count, *o_avg_wtd;
    bool *o_trigger_qa, *o_fi_active;
    int *o_ack_count;
    int n;
    int now;
};

__global__ void cc_update_kernel(CCArgs a, CCParamsC p) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= a.n) return;
    Flow s{a.cwnd[i], a.acked[i], a.qa_end[i], a.bytes_to_ignore[i],
           a.bytes_ignored[i], a.fi_count[i], a.avg_wtd[i],
           a.trigger_qa[i], a.fi_active[i], a.ack_count[i]};
    const FlowEvent e{a.has_ack[i], a.ecn[i], a.ack_bytes[i], a.rtt[i],
                      a.trim_bytes[i], a.to_bytes[i], a.unacked[i],
                      a.n_trims[i], a.n_timeouts[i]};
    smartt_flow(s, p, e, (float)a.now, a.brtt[i], a.trtt[i], a.mi[i]);

    a.o_cwnd[i] = s.cwnd;
    a.o_acked[i] = s.acked;
    a.o_qa_end[i] = s.qa_end;
    a.o_bytes_to_ignore[i] = s.bti;
    a.o_bytes_ignored[i] = s.big;
    a.o_fi_count[i] = s.fic;
    a.o_avg_wtd[i] = s.avg;
    a.o_trigger_qa[i] = s.tq;
    a.o_fi_active[i] = s.fa;
    a.o_ack_count[i] = s.ack_count;
}

REPRO_EXPORT int repro_cc_update(CCArgs args, CCParamsC params, void* stream) {
    const int threads = 256;
    const int blocks = (args.n + threads - 1) / threads;
    if (blocks > 0) {
        cc_update_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(args, params);
    }
    return (int)cudaGetLastError();
}
