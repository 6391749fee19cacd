"""Phases 1-2 of the tick — the switching fabric.

  1. ``departures``: dequeue head per port, RED dequeue-marking, route,
     blackhole on failed links, place on the wire
  2. ``arrivals``:  packets landing now -> enqueue (trim/drop on overflow)
     or deliver (receiver dedupe, ACK generation)

Both are ``(Dims, Consts, SimState, Clock) -> SimState``; they communicate
with the rest of the pipeline only through ``SimState`` fields (the wire
ring ``infl``, the delayed control rings, and the receiver ledgers).

``arrivals`` runs the whole phase in one call of the backend-resolved
``kernels/arrivals`` callable: the fused CUDA kernel on the card, its
plain version ``arrivals_ref`` otherwise, or under
``SimConfig.fabric_backend="split"`` the earlier design, ``arrivals_ref``
with the ``enqueue_rank`` kernel in it.

The rings (``infl``, ``ack_ring``, ``trim_ring``, ``q_fields``), the
queue sizes, the receiver ledgers (``bitmap``, ``goodput``, ``done``,
``fct``, ``trim_seen``) and the counters the phase adds to are updated in
place by ``arrivals``, which saves copying megabytes a tick: a state
passed to a phase is consumed, as the reference's run loops consume
(donate) theirs.

``horizon`` is the phases' next-event reduction for event-horizon time
leaping (DESIGN.md Sec. 6.3): every delay ring keeps the invariant that a
*valid* entry is a genuinely in-flight event (slots are zeroed when read).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.arrivals import ref as arrivals_ref
from repro_torch.netsim import faults, hashing
from repro_torch.netsim.metrics import isum
from repro_torch.netsim.state import HORIZON_INF, Clock, Consts, Dims, SimState

I32 = torch.int32
F32 = torch.float32


def _ecmp(ent, salt, cnt):
    """``hash2(ent, salt) % max(cnt, 1)`` in uint32 arithmetic, as i32."""
    h = hashing.hash2(ent, salt)
    return torch.remainder(h, cnt.clamp_min(1).to(torch.int64)).to(I32)


def route_switch(dims: Dims, consts: Consts, sw, d, ent):
    """Table-driven next hop at switch ``sw`` for a packet to node ``d``
    carrying path entropy ``ent`` (all broadcastable tensors): *down* when
    ``d`` lies in the switch's subtree interval (the run-length lookup
    ``dn_base[sw] + d // dn_stride[sw]``), *up* otherwise, the ECMP hash
    of the entropy with the switch's salt picking among its equal-cost up
    ports."""
    down = (d >= consts.sw_lo[sw]) & (d < consts.sw_hi[sw])
    h = _ecmp(ent, consts.sw_salt[sw], consts.sw_up_cnt[sw])
    return torch.where(
        down, consts.dn_base[sw] + torch.div(d, consts.dn_stride[sw], rounding_mode="floor"),
        consts.sw_up_base[sw] + h)


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


def route_from_sender(dims: Dims, consts: Consts, f, ent):
    """First queue for a fresh packet of flow ``f`` carrying entropy
    ``ent`` (broadcastable: the routing property tests walk [NF, 1] x
    [1, E] grids); the same per-flow tables and integers as
    :func:`route_first_hop`, which the tick uses for all flows at once."""
    h = _ecmp(ent, consts.f_salt[f], consts.f_up_cnt[f])
    return torch.where(consts.f_down[f], consts.f_dn_q[f], consts.f_up_base[f] + h)


def route_step(dims: Dims, consts: Consts, q, d, ent):
    """Next queue after departing port ``q`` toward node ``d``: the
    single-port form of :func:`route_from_queue` (delivery to node ``d``
    encoded as ``-(d + 1)``)."""
    nxt = route_switch(dims, consts, consts.nbr_q[q], d, ent)
    return torch.where(consts.edge_q[q], -(d + 1), nxt)


def red_marks(dims: Dims, consts: Consts, st: SimState, t: int):
    """RED marking at dequeue (paper Sec. 2.1 / 3.5): the coin flip of
    every port at tick ``t``, bool [NQ], before the ``active`` guard.
    The first hash lane t * 131071 + q wraps in i32 in the reference; the
    hash takes it mod 2**32, so computing it in int64 gives the same bits.

    The same function as the ``red_mark`` kernel's mark
    (``kernels/red_mark``) wherever ``kspan`` equals that kernel's
    ``max(kmax - kmin, 1e-6)``, with the salt ``0xECD + st.salt``."""
    qsz = st.q_size[:dims.NQ].to(F32)
    pmark = torch.clamp((qsz - consts.kmin) / consts.kspan, 0.0, 1.0)
    return hashing.uniform01(consts.qidx.to(torch.int64) + t * 131071,
                             st.salt + 0xECD) < pmark


def departures(dims: Dims, consts: Consts, st: SimState, clk: Clock) -> SimState:
    """Phase 1: one head-of-line packet per active port onto the wire."""
    t = clk.t
    m = st.m
    NQ, CAP, L = dims.NQ, dims.CAP, dims.L
    B = dims.QE                                       # core/edge port split

    qidx = consts.qidx
    # fault schedule: per-port service period at tick t (1 = healthy,
    # 0 = dead, k > 1 = serve when t % k == 0), only where a schedule exists
    faulty = bool(dims.FK or dims.flapped)
    active = st.q_size[:NQ] > 0
    if faulty:
        per = faults.port_period(dims, consts, t)
        svc = torch.where(per > 1, torch.remainder(t, per.clamp_min(1)) == 0, True)
        active = active & svc
    head = st.q_head[:NQ]
    hf = st.q_fields[qidx, head]                      # [NQ, 5]
    d_flow, d_seq, d_ent, d_ecn, d_ts = hf.unbind(1)
    d_ecn = d_ecn | (red_marks(dims, consts, st, t) & active).to(I32)
    emit = active
    if faulty:
        black = (per == 0) & active                   # dead link: blackhole
        emit = active & ~black
        m = m._replace(n_black=m.n_black + isum(black))
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
    return st._replace(q_head=q_head, q_size=q_size, infl=infl, m=m)


def flags(dims: Dims, consts: Consts, clk: Clock) -> arrivals_ref.Flags:
    """The run's constants that shape the fused phase (one device read,
    of the goodput bin width, a build)."""
    return arrivals_ref.Flags(
        trimming=dims.trimming, credit_based=dims.credit_based,
        faulty=bool(dims.FK or dims.flapped), mtu=dims.mtu, qe=dims.QE,
        ret=clk.ret, goodput_bin=int(consts.goodput_bin))


def operands(consts: Consts, st: SimState, fault_active) -> arrivals_ref.Operands:
    """The fused phase's tensors: the run's constants and the state's
    buffers (updated in place by the phase)."""
    m = st.m
    return arrivals_ref.Operands(
        enq_ids=consts.enq_ids, in_tbl=consts.in_tbl, in_pos=consts.in_pos,
        sw_of_q=consts.sw_of_q, dst=consts.dst, size=consts.size,
        t_start=consts.t_start, infl=st.infl, q_head=st.q_head, q_size=st.q_size,
        q_fields=st.q_fields, ack_ring=st.ack_ring, trim_ring=st.trim_ring,
        trim_seen=st.trim_seen, bitmap=st.bitmap, goodput=st.goodput, done=st.done,
        fct=st.fct, delivered_pkts=m.delivered_pkts, n_trim=m.n_trim, n_drop=m.n_drop,
        delivered_bytes=m.delivered_bytes, goodput_hist=m.goodput_hist,
        delivered_bytes_fault=m.delivered_bytes_fault, fault_active=fault_active)


def arrivals(dims: Dims, consts: Consts, st: SimState, clk: Clock, *,
             run, fl: arrivals_ref.Flags) -> SimState:
    """Phase 2: land this tick's wire slot — deliver at the edge (dedupe,
    ACK generation) or enqueue mid-fabric (trim/drop on overflow) — in one
    call of ``run`` (the backend resolved by ``kernels/arrivals/ops.get``),
    which updates the state's buffers in place."""
    t = clk.t
    slots = arrivals_ref.Slots(wire=t % dims.L, ack=(t + clk.ret) % dims.R,
                               trim=(t + clk.trim_delay) % dims.R)
    active = faults.fault_active(dims, consts, t) if fl.faulty else None
    run(t, slots, fl, operands(consts, st, active))
    return st


def horizon(dims: Dims, consts: Consts, st: SimState, clk: Clock):
    """Ticks until phases 1-2 next do work (DESIGN.md Sec. 6.3): 0 while
    any port holds a packet, else the earliest occupied wire slot's
    landing distance ``(s - t) mod L``; with a fault schedule, never past
    its next transition (no leap crosses a fail/degrade/repair/flap
    edge)."""
    busy = torch.any(st.q_size[:dims.NQ] > 0)
    live = torch.any(st.infl[:, :, 0] == 1, dim=1)                 # [L]
    dist = torch.remainder(consts.iota_l - clk.t, dims.L)
    h_wire = torch.min(torch.where(live, dist, HORIZON_INF))
    h = torch.where(busy, 0, h_wire)
    if dims.FK or dims.flapped:
        h = torch.minimum(h, faults.transition_horizon(dims, consts, clk.t))
    return h
