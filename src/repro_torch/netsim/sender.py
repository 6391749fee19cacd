"""Phases 4-5 of the tick — the host NICs.

  4. ``grants``: EQDS receiver-side pull-credit generation (round-robin
     over demanding flows per receiver, through the ``rr_pick`` kernel;
     a no-op unless the algorithm is credit-based)
  5. ``sends``:  per-sender round-robin flow arbitration, window/credit/
     pacing admission, REPS entropy assignment, emission onto the wire,
     sent-ring bookkeeping

Static branch selectors (credit_based / paced / lb_mode / window) come
from ``Dims``.  ``horizon`` reduces the same admission/demand predicates
to "ticks until a NIC or a receiver next acts" (DESIGN.md Sec. 6.3).
"""

from __future__ import annotations

import torch

from repro_torch.core import reps
from repro_torch.netsim.fabric import route_first_hop
from repro_torch.netsim.metrics import isum
from repro_torch.netsim.state import HORIZON_INF, Clock, Consts, Dims, SimState

I32 = torch.int32
F32 = torch.float32


def activated(dims: Dims, consts: Consts, st: SimState, clk: Clock):
    """The activation predicate (DESIGN.md Sec. 11): a flow is live once
    ``t >= t_start``, it is unfinished, and — when the workload carries a
    dependency table — every parent has delivered its threshold bytes."""
    act = (clk.t >= consts.t_start) & ~st.done
    if dims.D:
        # goodput of each parent (pad row NF covers the free-slot sentinel)
        gp = torch.cat([st.goodput, st.goodput.new_zeros(1)])[consts.dep_par]
        ok = (consts.dep_par == dims.NF) | (gp >= consts.dep_thr)
        act = act & torch.all(ok, dim=1)
    return act


def _grant_demand(dims: Dims, consts: Consts, st: SimState, clk: Clock):
    """Flows whose receiver owes pull credit (EQDS): outstanding credit
    window above received + known-lost bytes — self-clocks, and re-grants
    for trimmed packets (the receiver sees trimmed headers) so
    retransmissions never starve."""
    return activated(dims, consts, st, clk) & (
        st.granted - st.goodput.to(F32) - st.trim_seen[:dims.NF]
        < consts.credit_window)


def grants(dims: Dims, consts: Consts, st: SimState, clk: Clock, *, arb) -> SimState:
    """Phase 4: EQDS receiver credit grants (paper Sec. 2.2): each receiver
    grants one MTU of credit to one demanding flow, picked round-robin by
    ``arb`` (the backend-resolved ``rr_pick``) over its ``[N, FRMAX]``
    flow table.  The credit ring slot is updated in place."""
    if not dims.credit_based:
        return st
    NF, FRMAX = dims.NF, dims.FRMAX
    demand = _grant_demand(dims, consts, st, clk)
    dm = torch.cat([demand, demand.new_zeros(1)])[consts.flows_by_recv]   # [N, FR]
    has_g, sel = arb(dm, st.rr_recv, FRMAX)
    gflow = torch.where(has_g, consts.flows_by_recv[consts.node_ids, sel], NF)
    credit = torch.where(has_g, float(dims.mtu), 0.0)
    # the grant return delay is the constant `ret`, so all grants of this
    # tick land in one ring slot; a flow has one receiver, so every real
    # grant lands on its own column (the idle ones add 0.0 to column NF)
    credit_ring = st.credit_ring
    credit_ring[(clk.t + clk.ret) % dims.R].index_add_(0, gflow, credit)
    granted = torch.cat([st.granted, st.granted.new_zeros(1)]).index_add_(
        0, gflow, credit)[:NF]
    rr_recv = torch.where(has_g, torch.remainder(sel + 1, FRMAX), st.rr_recv)
    return st._replace(credit_ring=credit_ring, granted=granted, rr_recv=rr_recv)


def admission(dims: Dims, consts: Consts, st: SimState, clk: Clock):
    """Send admission for every flow at the current tick, *excluding* rate
    pacing (``sends`` folds in the freshly accrued pacing budget; the leap
    ``horizon`` runs only for unpaced configurations, where this is the
    full admission).  Returns ``(elig, has_retx, seq_emit, nsize)``."""
    NF, W, FMAX, window = dims.NF, dims.W, dims.FMAX, dims.window
    mtu_i = dims.mtu
    flow_ids = consts.flow_ids
    cc = st.cc

    started = activated(dims, consts, st, clk)
    if window < FMAX:
        # windowed-alltoall eligibility: < window unfinished predecessors,
        # gathered from the per-sender prefix count
        done_p = torch.cat([st.done, st.done.new_ones(1)])
        unfin = ~done_p[consts.flows_of] & (consts.flows_of < NF)   # [N, FMAX]
        prior_unfin = torch.cumsum(unfin, dim=1, dtype=I32) - unfin.to(I32)
        started = started & (prior_unfin[consts.src, consts.slot_of] < window)

    is_retx = st.sent[0, :NF] == 3
    has_retx = torch.any(is_retx, dim=1)
    retx_slot = torch.argmax(is_retx.to(I32), dim=1)     # first index on ties
    retx_seq = st.sent[1, flow_ids, retx_slot]
    new_seq = st.next_seq
    new_slot = torch.remainder(new_seq, W)
    new_ok = (new_seq * mtu_i < consts.size) & \
        (st.sent[0, flow_ids, new_slot] == 0)
    seq_emit = torch.where(has_retx, retx_seq, new_seq)
    nsize = (consts.size - seq_emit * mtu_i).clamp(0, mtu_i).to(F32)
    win_ok = st.unacked + nsize <= cc.cwnd
    elig = started & (has_retx | new_ok) & win_ok & (nsize > 0)
    if dims.credit_based:
        elig = elig & ((cc.credits >= nsize) | (cc.spec_budget >= nsize))
    return elig, has_retx, seq_emit, nsize


def sends(dims: Dims, consts: Consts, st: SimState, clk: Clock, *, arb) -> SimState:
    """Phase 5: one packet per NIC per tick, arbitration + admission.

    ``arb`` is the backend-resolved round-robin arbitration callable
    (``kernels/enqueue_arb/ops.get``).  The wire ring and the sent ring
    are updated in place."""
    t = clk.t
    m = st.m
    NF, N, NQ, L, W = dims.NF, dims.N, dims.NQ, dims.L, dims.W
    FMAX = dims.FMAX
    flow_ids = consts.flow_ids
    dev = st.now.device
    cc = st.cc

    pace = st.pace_accum
    if dims.paced:
        pace = torch.clamp_max(pace + cc.pacing_rate, 4.0 * float(dims.mtu))

    elig, has_retx, seq_emit, nsize = admission(dims, consts, st, clk)
    if dims.paced:
        elig = elig & (pace >= nsize)

    # per-sender round-robin arbitration (one packet per NIC per tick)
    elig_p = torch.cat([elig, elig.new_zeros(1)])
    if FMAX == 1:
        # at most one flow per sender: arbitration is the identity
        has_s = elig_p[consts.flows_of[:, 0]]
        sflow = torch.where(has_s, consts.flows_of[:, 0], NF)
        rr_send = st.rr_send
    else:
        E = elig_p[consts.flows_of]                             # [N, FMAX]
        has_s, sel = arb(E, st.rr_send, FMAX)
        sflow = torch.where(has_s, consts.flows_of[consts.node_ids, sel], NF)
        rr_send = torch.where(has_s, torch.remainder(sel + 1, FMAX), st.rr_send)

    # flow f emits iff its own sender selected it (gather, not scatter)
    emit_mask = sflow[consts.src] == flow_ids
    lb, entropy = reps.on_send(dims.lb_mode, consts.lb, st.lb, emit_mask,
                               seq_emit, flow_ids, t)
    first_q = route_first_hop(dims, consts, entropy)

    # place on the wire: the NIC emitter rows [NQ, NE) of the (uniform)
    # sender-latency slot, zeros for idle NICs, in place
    sf = sflow.clamp(0, NF - 1)
    spay = torch.where(has_s[:, None], torch.stack([
        has_s.to(I32),
        first_q[sf],
        sflow,
        seq_emit[sf],
        entropy[sf],
        torch.zeros((N,), dtype=I32, device=dev),
        torch.full((N,), t, dtype=I32, device=dev),
    ], dim=1), 0)
    infl = st.infl
    infl[(t + clk.lat_send) % L, NQ:] = spay

    # sent-ring bookkeeping: one-hot masked write of the [3, NF, W] body
    # (the emitting flow's slot is seq_emit % W), in place; the write-off
    # row NF is never touched
    hit = emit_mask[:, None] & \
        (torch.arange(W, dtype=I32, device=dev)[None, :]
         == torch.remainder(seq_emit, W)[:, None])
    body = st.sent[:, :NF]
    new_body = torch.stack([
        torch.where(hit, 1, body[0]),
        torch.where(hit, seq_emit[:, None], body[1]),
        torch.where(hit, t, body[2]),
    ])
    sent = st.sent
    sent[:, :NF] = new_body
    is_new_send = emit_mask & ~has_retx
    next_seq = st.next_seq + is_new_send.to(I32)
    m = m._replace(n_retx=m.n_retx + isum(emit_mask & has_retx))

    spend = torch.where(emit_mask, nsize, 0.0)
    if dims.credit_based:
        use_credit = cc.credits >= nsize
        cc = cc._replace(
            credits=cc.credits - spend * use_credit,
            spec_budget=cc.spec_budget - spend * ~use_credit,
        )
    if dims.paced:
        pace = pace - spend

    return st._replace(
        infl=infl, sent=sent, next_seq=next_seq, rr_send=rr_send,
        pace_accum=pace, cc=cc, lb=lb, m=m,
    )


def horizon(dims: Dims, consts: Consts, st: SimState, clk: Clock):
    """Ticks until phases 4-5 next do work (DESIGN.md Sec. 6.3): 0 while
    any flow passes send admission or — for credit-based algorithms — any
    receiver owes a grant, else the nearest flow-start deadline (between
    events nothing else can flip either predicate).  Never called for
    paced configurations (``Dims.leap`` is off there: the pacing budget
    accrues every tick)."""
    t = clk.t
    elig, _, _, _ = admission(dims, consts, st, clk)
    h = torch.where(torch.any(elig), 0, HORIZON_INF)
    if dims.credit_based:
        h = torch.minimum(h, torch.where(
            torch.any(_grant_demand(dims, consts, st, clk)), 0, HORIZON_INF))
    unstarted = t < consts.t_start
    h_start = torch.min(torch.where(unstarted, consts.t_start - t, HORIZON_INF))
    return torch.minimum(h, h_start)
