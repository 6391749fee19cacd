"""Phases 1-2 of the tick — the switching fabric.

  1. ``departures``: dequeue head per port, RED dequeue-marking, route,
     place on the wire
  2. ``arrivals``:  packets landing now -> enqueue (trim/drop on overflow)
     or deliver (receiver dedupe, ACK generation)

Both are ``(Dims, Consts, SimState, Clock) -> SimState``; they communicate
with the rest of the pipeline only through ``SimState`` fields (the wire
ring ``infl``, the delayed control rings, and the receiver ledgers).

The large rings (``infl``, ``ack_ring``, ``trim_ring``, ``q_fields``) are
updated in place, which saves copying megabytes a tick: a state passed to
a phase is consumed, as the reference's run loops consume (donate) theirs.

``horizon`` is the phases' next-event reduction for event-horizon time
leaping (DESIGN.md Sec. 6.3): every delay ring keeps the invariant that a
*valid* entry is a genuinely in-flight event (slots are zeroed when read).
"""

from __future__ import annotations

import torch

from repro_torch.netsim import hashing
from repro_torch.netsim.metrics import isum
from repro_torch.netsim.state import HORIZON_INF, Clock, Consts, Dims, SimState, pkt_size

I32 = torch.int32
F32 = torch.float32


def _ecmp(ent, salt, cnt):
    """``hash2(ent, salt) % max(cnt, 1)`` in uint32 arithmetic, as i32."""
    h = hashing.hash2(ent, salt)
    return torch.remainder(h, cnt.clamp_min(1).to(torch.int64)).to(I32)


def route_from_queue(dims: Dims, consts: Consts, flow, ent):
    """Next queue for the packet departing each fabric port (``flow`` /
    ``ent`` are [NQ], one head-of-line packet per port; negative ids encode
    delivery to node -(id+1)).  Each port's wire feeds the switch
    ``consts.nbr_q`` names, read through the pre-gathered per-queue tables
    ``q_*``; the last N ports (``consts.edge_q``) feed host NICs."""
    d = consts.dst[flow.clamp(0, dims.NF - 1)]
    down = (d >= consts.q_lo) & (d < consts.q_hi)
    h = _ecmp(ent, consts.q_salt, consts.q_up_cnt)
    nxt = torch.where(
        down, consts.q_dn_base + torch.div(d, consts.q_dn_stride, rounding_mode="floor"),
        consts.q_up_base + h)
    return torch.where(consts.edge_q, -(d + 1), nxt)


def route_first_hop(dims: Dims, consts: Consts, ent):
    """First queue for a fresh packet of *every* flow (``ent`` is the
    [NF] per-flow entropy): a select between the precomputed same-rack
    edge queue and the hashed rack uplink."""
    h = _ecmp(ent, consts.f_salt, consts.f_up_cnt)
    return torch.where(consts.f_down, consts.f_dn_q, consts.f_up_base + h)


def departures(dims: Dims, consts: Consts, st: SimState, clk: Clock) -> SimState:
    """Phase 1: one head-of-line packet per active port onto the wire."""
    t = clk.t
    NQ, CAP, L = dims.NQ, dims.CAP, dims.L
    B = dims.QE                                       # core/edge port split

    qidx = consts.qidx
    active = st.q_size[:NQ] > 0                       # no faults: svc = True
    head = st.q_head[:NQ]
    hf = st.q_fields[qidx, head]                      # [NQ, 5]
    d_flow, d_seq, d_ent, d_ecn, d_ts = hf.unbind(1)
    # RED marking at dequeue (paper Sec. 2.1 / 3.5).  The first hash lane
    # t * 131071 + q wraps in i32 in the reference; the hash takes it mod
    # 2**32, so computing it in int64 gives the same bits.
    qsz = st.q_size[:NQ].to(F32)
    pmark = torch.clamp((qsz - consts.kmin) / consts.kspan, 0.0, 1.0)
    mark = hashing.uniform01(qidx.to(torch.int64) + t * 131071,
                             st.salt + 0xECD) < pmark
    d_ecn = d_ecn | (mark & active).to(I32)
    emit = active                                     # nothing blackholes
    next_q = route_from_queue(dims, consts, d_flow, d_ent)
    q_head = st.q_head.clone()
    q_head[:NQ] = torch.where(active, torch.remainder(head + 1, CAP), head)
    q_size = st.q_size.clone()
    q_size[:NQ] -= active.to(I32)
    payload = torch.where(emit[:, None], torch.stack(
        [emit.to(I32), next_q, d_flow, d_seq, d_ent, d_ecn, d_ts], dim=1), 0)
    # wire placement: each emitter's target slot (t + lat) % L holds nothing
    # still live, so blanket-writing zeros for inactive ports is exact
    # (fabric.py:146-152 of the reference); written in place
    infl = st.infl
    infl[(t + clk.lat_core) % L, :B] = payload[:B]
    infl[(t + clk.lat_edge) % L, B:NQ] = payload[B:]
    return st._replace(q_head=q_head, q_size=q_size, infl=infl)


def arrivals(dims: Dims, consts: Consts, st: SimState, clk: Clock, *,
             enqueue) -> SimState:
    """Phase 2: land this tick's wire slot — deliver at the edge (dedupe,
    ACK generation) or enqueue mid-fabric (trim/drop on overflow).

    ``enqueue`` is the backend-resolved enqueue-rank callable
    (``kernels/enqueue_arb/ops.get``)."""
    t = clk.t
    m = st.m
    NF, NQ, N = dims.NF, dims.NQ, dims.N
    CAP, L, R = dims.CAP, dims.L, dims.R
    dev = st.now.device

    # read this tick's wire slot, then zero it in place: the wire ring then
    # only ever holds live packets (what `horizon` relies on)
    arr = st.infl[t % L].clone()                      # [NE, 7]
    infl = st.infl
    infl[t % L] = 0

    # ---- deliveries (the t0_down rows [QE, QE+N): row i delivers to node i) ----
    lo = dims.QE
    darr = arr[lo:lo + N]
    deliver = (darr[:, 0] == 1) & (darr[:, 1] < 0)
    d_flow, d_seq, d_ent, d_ecn, d_ts = (darr[:, i] for i in range(2, 7))
    # receiver ledgers in the flow-major view: flow f's packets can only
    # land at node dst[f], one delivery per node per tick
    dview = darr[consts.dst]                          # [NF, 7]
    del_f = (dview[:, 0] == 1) & (dview[:, 1] < 0) & \
        (dview[:, 2] == consts.flow_ids)
    seq_f = torch.where(del_f, dview[:, 3], 0)
    word_f = torch.div(seq_f, 32, rounding_mode="floor")
    bit_f = torch.remainder(seq_f, 32)
    wsel = word_f[:, None] == torch.arange(dims.MAXW, dtype=I32, device=dev)
    bm = st.bitmap[:NF]
    old_w = isum(torch.where(wsel, bm, 0), dim=1)
    isnew_f = del_f & (((old_w >> bit_f) & 1) == 0)
    bitmap = st.bitmap.clone()
    bitmap[:NF] = bm + torch.where(wsel & isnew_f[:, None],
                                   (torch.ones_like(bit_f) << bit_f)[:, None], 0)
    psz_f = torch.where(isnew_f,
                        (consts.size - seq_f * dims.mtu).clamp(0, dims.mtu), 0)
    goodput = st.goodput + psz_f
    newly_done = (goodput >= consts.size) & ~st.done
    done = st.done | newly_done
    fct = torch.where(newly_done, t + consts.ret - consts.t_start, st.fct)
    # ACK generation (echoes entropy + ECN + timestamp; priority path): the
    # return delay is constant, so slot (t+ret) % R is exclusively this
    # tick's — written whole, in place
    ack_payload = torch.where(deliver[:, None], torch.stack(
        [deliver.to(I32), d_flow, d_seq, d_ecn, d_ent, d_ts], dim=1), 0)
    ack_ring = st.ack_ring
    ack_ring[(t + clk.ret) % R] = ack_payload
    dbytes = isum(psz_f).to(F32)
    m = m._replace(
        delivered_pkts=m.delivered_pkts + isum(deliver),
        delivered_bytes=m.delivered_bytes + dbytes,
    )

    # ---- enqueues, on the compact [EQ] axis of enqueue-capable emitters ----
    earr = arr[consts.enq_ids]                        # [EQ, 7]
    e_dstq, e_flow, e_seq, e_ent, e_ecn, e_ts = (earr[:, i] for i in range(1, 7))
    enq = (earr[:, 0] == 1) & (e_dstq >= 0)
    edst = torch.where(enq, e_dstq, NQ)
    acc, pos, q_counts = enqueue(consts.in_tbl, consts.in_pos,
                                 consts.sw_of_q, edst, st.q_head, st.q_size,
                                 CAP, NQ)
    row = torch.where(acc, edst, NQ)
    posw = torch.where(acc, pos, 0)
    # indices are NOT unique: every non-accepted emitter collapses onto the
    # write-off cell (NQ, 0) under a zero payload, so whichever write lands
    # there, the cell stays zero (fabric.py:274-282 of the reference);
    # the accepted (row, pos) pairs are distinct.  Written in place.
    q_fields = st.q_fields
    q_fields.index_put_(
        (row, posw),
        torch.where(acc[:, None],
                    torch.stack([e_flow, e_seq, e_ent, e_ecn, e_ts], dim=1), 0))
    q_size = st.q_size.clone()
    q_size[:NQ] += q_counts
    rej = (edst < NQ) & ~acc
    # trim (paper: only when the buffer is full) or drop
    rflow = torch.where(rej, e_flow, NF)
    rej_pkt = pkt_size(dims, consts, e_flow, e_seq)
    rej_bytes_i = torch.where(rej, rej_pkt, 0)
    if dims.trimming:
        W, WW = dims.W, dims.WW
        # one packed update feeds the delayed trim ledger (count, bytes and
        # the WW per-slot loss words): staged flow-major with an integer
        # scatter-add (order-free), then added into the ring slot in place
        wslot = torch.div(torch.remainder(e_seq, W), 32, rounding_mode="floor")
        wbit = torch.remainder(torch.remainder(e_seq, W), 32)
        # bit 31 is 1 << 31 in i32, i.e. -2**31, exactly as in the reference
        words = torch.where(
            rej[:, None] & (wslot[:, None] == torch.arange(WW, dtype=I32, device=dev)),
            (torch.ones_like(wbit) << wbit)[:, None], 0)
        upd = torch.cat(
            [rej.to(I32)[:, None], rej_bytes_i[:, None], words], dim=1)
        staged = torch.zeros((NF + 1, 2 + WW), dtype=I32, device=dev)
        staged.index_add_(0, rflow, upd)
        trim_ring = st.trim_ring
        trim_ring[(t + clk.trim_delay) % R] += staged
        m = m._replace(n_trim=m.n_trim + isum(rej))
    else:
        trim_ring = st.trim_ring
        m = m._replace(n_drop=m.n_drop + isum(rej))

    return st._replace(
        infl=infl, bitmap=bitmap, goodput=goodput, done=done, fct=fct,
        ack_ring=ack_ring, q_fields=q_fields, q_size=q_size,
        trim_ring=trim_ring, m=m,
    )


def horizon(dims: Dims, consts: Consts, st: SimState, clk: Clock):
    """Ticks until phases 1-2 next do work (DESIGN.md Sec. 6.3): 0 while
    any port holds a packet, else the earliest occupied wire slot's
    landing distance ``(s - t) mod L``."""
    busy = torch.any(st.q_size[:dims.NQ] > 0)
    live = torch.any(st.infl[:, :, 0] == 1, dim=1)                 # [L]
    dist = torch.remainder(consts.iota_l - clk.t, dims.L)
    h_wire = torch.min(torch.where(live, dist, HORIZON_INF))
    return torch.where(busy, 0, h_wire)
