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
// Design: the arithmetic follows the expression order of
// repro_torch/core/smartt.py (and so of the reference) operation by
// operation.  Built with --fmad=false, no multiply-add is contracted, so
// every f32 result is bit-equal to the plain PyTorch version, where each
// operation is its own kernel.  The 13 scalar parameters arrive by value
// in a struct, as the reference's packed parameter vector does; like the
// reference (cc_update/ref.py:30) `react_every` arrives as f32 and is cast
// to int.
#include "common.cuh"

struct CCParamsC {
    float mtu, bdp, maxcwnd, mincwnd, fd, md, fi, k_fast, qa_scaling,
        wtd_alpha, wtd_thresh, fi_rtt_tol, react_every;
};

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

struct Flow {
    float cwnd, acked, qa_end, bti, big, fic, avg;
    bool tq, fa;
};

// Alg. 2 (smartt.py quick_adapt): every right-hand side reads the state
// as it was on entry, as the reference's where() chain does.
__device__ __forceinline__ bool quick_adapt(Flow& s, const CCParamsC& p,
                                            float trtt, float unacked,
                                            float now, bool gate) {
    bool boundary = gate && (now >= s.qa_end);
    bool fire = boundary && s.tq && (s.qa_end != 0.0f);
    float cwnd = fire ? fmax_t(s.acked, p.mtu) * p.qa_scaling : s.cwnd;
    float bti = fire ? unacked : s.bti;
    float big = fire ? 0.0f : s.big;
    bool tq = s.tq && !fire;
    float qa_end = boundary ? now + trtt : s.qa_end;
    float acked = boundary ? 0.0f : s.acked;
    s.cwnd = cwnd; s.bti = bti; s.big = big; s.tq = tq;
    s.qa_end = qa_end; s.acked = acked;
    return fire;
}

__global__ void cc_update_kernel(CCArgs a, CCParamsC p) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= a.n) return;
    const float now = (float)a.now;
    const float brtt = a.brtt[i], trtt = a.trtt[i], mi = a.mi[i];
    Flow s{a.cwnd[i], a.acked[i], a.qa_end[i], a.bytes_to_ignore[i],
           a.bytes_ignored[i], a.fi_count[i], a.avg_wtd[i],
           a.trigger_qa[i], a.fi_active[i]};
    int ack_count = a.ack_count[i];
    const bool has = a.has_ack[i], ecn = a.ecn[i];
    const float ev_rtt = a.rtt[i], unacked = a.unacked[i];

    // ---------------- ACK branch (Alg. 1 l. 7-27) ----------------
    float size = has ? a.ack_bytes[i] : 0.0f;
    s.acked = s.acked + size;
    s.big = s.big + size;
    bool ignoring = s.big < s.bti;
    bool act = has && !ignoring;

    ack_count = ack_count + (act ? 1 : 0);
    int re = (int)p.react_every;
    re = re > 1 ? re : 1;
    bool react = act && (floor_mod(ack_count, re) == 0);

    float ecn_f = ecn ? 1.0f : 0.0f;
    float avg_new = p.wtd_alpha * ecn_f + (1.0f - p.wtd_alpha) * s.avg;
    s.avg = act ? avg_new : s.avg;
    bool can_decrease = s.avg >= p.wtd_thresh;

    bool adp = quick_adapt(s, p, trtt, unacked, now, act);

    // Alg. 3 (smartt.py fast_increase), on the raw event rtt
    bool near_base = act && !ecn && (ev_rtt <= brtt * p.fi_rtt_tol + 1.0f);
    float count = near_base ? s.fic + size : 0.0f;
    bool finc = near_base && ((count > s.cwnd) || s.fa);
    s.cwnd = finc ? s.cwnd + p.k_fast * p.mtu : s.cwnd;
    s.fa = act ? finc : s.fa;
    s.fic = act ? count : s.fic;

    // l. 19-27: the four window actions
    bool go = react && !(adp || finc);
    float rtt = fmax_t(ev_rtt, 1e-6f);
    float cwnd = fmax_t(s.cwnd, 1.0f);

    float fd_amt = cwnd / p.bdp * p.fd * size;                           // Eq. 1
    float md_amt = fmin_t(size, (rtt - trtt) / rtt * p.md * size);       // Eq. 2
    float fi_amt = size / cwnd * p.mtu * p.fi;                           // Eq. 3
    float mi_amt = fmin_t(size, (trtt - rtt) / rtt * size / cwnd * p.mtu * mi);  // Eq. 4

    float is_fd = (go && ecn && (rtt <= trtt) && can_decrease) ? 1.0f : 0.0f;
    float is_md = (go && ecn && (rtt > trtt) && can_decrease) ? 1.0f : 0.0f;
    float is_fi = (go && !ecn && (rtt > trtt)) ? 1.0f : 0.0f;
    float is_mi = (go && !ecn && (rtt <= trtt)) ? 1.0f : 0.0f;

    float delta = -fd_amt * is_fd
                  - (md_amt + fd_amt) * is_md
                  + fi_amt * is_fi
                  + (mi_amt + fi_amt) * is_mi;
    s.cwnd = s.cwnd + delta;

    // ---------------- trim / timeout branch (Alg. 1 l. 28-35) ----------------
    int n_trims = a.n_trims[i];
    bool lost = (n_trims + a.n_timeouts[i]) > 0;
    float lost_bytes = a.trim_bytes[i] + a.to_bytes[i];
    float hdr_bytes = 64.0f * (float)n_trims;        // units.HDR_BYTES
    s.acked = s.acked + hdr_bytes;
    s.big = s.big + hdr_bytes;
    s.cwnd = s.cwnd - (lost ? lost_bytes : 0.0f);
    s.tq = s.tq || lost;
    bool qa_gate = lost && (s.big >= s.bti);
    quick_adapt(s, p, trtt, unacked, now, qa_gate);

    // l. 36: clamp
    s.cwnd = fmin_t(fmax_t(s.cwnd, p.mincwnd), p.maxcwnd);

    a.o_cwnd[i] = s.cwnd;
    a.o_acked[i] = s.acked;
    a.o_qa_end[i] = s.qa_end;
    a.o_bytes_to_ignore[i] = s.bti;
    a.o_bytes_ignored[i] = s.big;
    a.o_fi_count[i] = s.fic;
    a.o_avg_wtd[i] = s.avg;
    a.o_trigger_qa[i] = s.tq;
    a.o_fi_active[i] = s.fa;
    a.o_ack_count[i] = ack_count;
}

REPRO_EXPORT int repro_cc_update(CCArgs args, CCParamsC params, void* stream) {
    const int threads = 256;
    const int blocks = (args.n + threads - 1) / threads;
    if (blocks > 0) {
        cc_update_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(args, params);
    }
    return (int)cudaGetLastError();
}
