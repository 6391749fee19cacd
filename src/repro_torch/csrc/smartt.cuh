// SMaRTT per-flow congestion-window update (paper Alg. 1-3) as a device
// function of one flow's registers.  `cc_update.cu` (one thread a flow
// over the state planes) and `control.cu` (the fused control phase, lane
// 0 of each flow's warp) both call it, so the two cannot drift apart.
//
// The arithmetic follows the expression order of
// repro_torch/core/smartt.py (and so of the reference) operation by
// operation.  Built with --fmad=false, no multiply-add is contracted, so
// every f32 result is bit-equal to the plain PyTorch version, where each
// operation is its own kernel.  The 13 scalar parameters arrive in a
// struct, as the reference's packed parameter vector does (by value to
// cc_update.cu; control.cu reads it from the device, one a lane); like the
// reference (cc_update/ref.py:30) `react_every` arrives as f32 and is cast
// to int.
#pragma once

#include "common.cuh"

struct CCParamsC {
    float mtu, bdp, maxcwnd, mincwnd, fd, md, fi, k_fast, qa_scaling,
        wtd_alpha, wtd_thresh, fi_rtt_tol, react_every;
};

// One flow's SMaRTT state (the ten planes of CCState that the update
// touches; ack_count kept beside it).
struct Flow {
    float cwnd, acked, qa_end, bti, big, fic, avg;
    bool tq, fa;
    int ack_count;
};

// One flow's events of this tick (CCEvent without the fields SMaRTT does
// not read) and its per-flow parameters.
struct FlowEvent {
    bool has, ecn;
    float ack_bytes, rtt, trim_bytes, to_bytes, unacked;
    int n_trims, n_timeouts;
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

// Alg. 1 for one flow at tick `now` (smartt.py smartt_update).
__device__ __forceinline__ void smartt_flow(Flow& s, const CCParamsC& p,
                                            const FlowEvent& e, float now,
                                            float brtt, float trtt, float mi) {
    // ---------------- ACK branch (Alg. 1 l. 7-27) ----------------
    float size = e.has ? e.ack_bytes : 0.0f;
    s.acked = s.acked + size;
    s.big = s.big + size;
    bool ignoring = s.big < s.bti;
    bool act = e.has && !ignoring;

    s.ack_count = s.ack_count + (act ? 1 : 0);
    int re = (int)p.react_every;
    re = re > 1 ? re : 1;
    bool react = act && (floor_mod(s.ack_count, re) == 0);

    float ecn_f = e.ecn ? 1.0f : 0.0f;
    float avg_new = p.wtd_alpha * ecn_f + (1.0f - p.wtd_alpha) * s.avg;
    s.avg = act ? avg_new : s.avg;
    bool can_decrease = s.avg >= p.wtd_thresh;

    bool adp = quick_adapt(s, p, trtt, e.unacked, now, act);

    // Alg. 3 (smartt.py fast_increase), on the raw event rtt
    bool near_base = act && !e.ecn && (e.rtt <= brtt * p.fi_rtt_tol + 1.0f);
    float count = near_base ? s.fic + size : 0.0f;
    bool finc = near_base && ((count > s.cwnd) || s.fa);
    s.cwnd = finc ? s.cwnd + p.k_fast * p.mtu : s.cwnd;
    s.fa = act ? finc : s.fa;
    s.fic = act ? count : s.fic;

    // l. 19-27: the four window actions
    bool go = react && !(adp || finc);
    float rtt = fmax_t(e.rtt, 1e-6f);
    float cwnd = fmax_t(s.cwnd, 1.0f);

    float fd_amt = cwnd / p.bdp * p.fd * size;                           // Eq. 1
    float md_amt = fmin_t(size, (rtt - trtt) / rtt * p.md * size);       // Eq. 2
    float fi_amt = size / cwnd * p.mtu * p.fi;                           // Eq. 3
    float mi_amt = fmin_t(size, (trtt - rtt) / rtt * size / cwnd * p.mtu * mi);  // Eq. 4

    float is_fd = (go && e.ecn && (rtt <= trtt) && can_decrease) ? 1.0f : 0.0f;
    float is_md = (go && e.ecn && (rtt > trtt) && can_decrease) ? 1.0f : 0.0f;
    float is_fi = (go && !e.ecn && (rtt > trtt)) ? 1.0f : 0.0f;
    float is_mi = (go && !e.ecn && (rtt <= trtt)) ? 1.0f : 0.0f;

    float delta = -fd_amt * is_fd
                  - (md_amt + fd_amt) * is_md
                  + fi_amt * is_fi
                  + (mi_amt + fi_amt) * is_mi;
    s.cwnd = s.cwnd + delta;

    // ---------------- trim / timeout branch (Alg. 1 l. 28-35) ----------------
    bool lost = (e.n_trims + e.n_timeouts) > 0;
    float lost_bytes = e.trim_bytes + e.to_bytes;
    float hdr_bytes = 64.0f * (float)e.n_trims;      // units.HDR_BYTES
    s.acked = s.acked + hdr_bytes;
    s.big = s.big + hdr_bytes;
    s.cwnd = s.cwnd - (lost ? lost_bytes : 0.0f);
    s.tq = s.tq || lost;
    bool qa_gate = lost && (s.big >= s.bti);
    quick_adapt(s, p, trtt, e.unacked, now, qa_gate);

    // l. 36: clamp
    s.cwnd = fmin_t(fmax_t(s.cwnd, p.mincwnd), p.maxcwnd);
}
