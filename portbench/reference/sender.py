"""Phases 4-5 of the tick — the host NICs.

  4. ``grants``: EQDS receiver-side pull-credit generation (round-robin over
     demanding flows per receiver; no-op unless the algorithm is
     credit-based)
  5. ``sends``:  per-sender round-robin flow arbitration, window/credit/
     pacing admission, REPS entropy assignment, emission onto the wire,
     sent-ring bookkeeping

Static branch selectors (credit_based / paced / lb_mode / window) come from
``Dims``; every numeric knob is traced through ``Consts``.

``horizon`` reduces the same admission/demand predicates to "ticks until a
NIC or a receiver next acts", feeding the engine's event-horizon time
leaping (DESIGN.md Sec. 6.3).
"""

from __future__ import annotations

from . import np32 as jnp

from . import reps
from .fabric import route_first_hop
from .state import HORIZON_INF, Consts, Dims, SimState

I32 = jnp.int32
F32 = jnp.float32


def activated(dims: Dims, consts: Consts, st: SimState):
    """The activation predicate (DESIGN.md Sec. 11): a flow is live once
    ``t >= t_start``, it is unfinished, and — when the workload carries a
    dependency table — every parent has delivered its threshold bytes.

    ``st.goodput`` only grows on delivery (an *eventful* tick by
    construction), so between events this predicate is constant: the leap
    horizon needs no dependency-release term beyond sharing this exact
    predicate with ``admission`` (the clamp that keeps leap-on bit-equal
    to leap-off).  With ``Dims.D == 0`` the dependency gather vanishes and
    the traced graph is the legacy ``t_start``-only one, bit-for-bit."""
    act = (st.now >= consts.t_start) & ~st.done
    if dims.D:
        # goodput of each parent (pad row NF covers the free-slot sentinel,
        # which the == NF test forces true regardless)
        gp = jnp.pad(st.goodput, (0, 1))[consts.dep_par]        # [NF, D]
        ok = (consts.dep_par == dims.NF) | (gp >= consts.dep_thr)
        act &= jnp.all(ok, axis=1)
    return act


def _grant_demand(dims: Dims, consts: Consts, st: SimState):
    """Flows whose receiver owes pull credit (EQDS): outstanding credit
    window above received + known-lost bytes — self-clocks, and re-grants
    for trimmed packets (the receiver sees trimmed headers) so
    retransmissions never starve."""
    return activated(dims, consts, st) & (
        st.granted - st.goodput.astype(F32) - st.trim_seen[:dims.NF]
        < consts.credit_window)


def grants(dims: Dims, consts: Consts, st: SimState, arb=None) -> SimState:
    """Phase 4: EQDS receiver credit grants (paper Sec. 2.2).

    ``arb`` is the backend-resolved round-robin arbitration callable
    (``kernels/enqueue_arb/ops.get``); ``None`` means the pure-jnp
    reference."""
    if not dims.credit_based:
        return st
    if arb is None:
        from . import enqueue_arb_ops as _arb_ops
        arb = _arb_ops.rr_pick
    t = st.now
    NF, N, R, FRMAX = dims.NF, dims.N, dims.R, dims.FRMAX
    MTU = float(dims.mtu)

    demand = _grant_demand(dims, consts, st)
    dm = jnp.pad(demand, (0, 1))[consts.flows_by_recv]          # [N, FR]
    has_g, sel = arb(dm, st.rr_recv, FRMAX)
    gflow = jnp.where(has_g, consts.flows_by_recv[consts.node_ids, sel], NF)
    # the grant return delay is the constant `ret` (state.derive), so all
    # grants of this tick land in one ring slot
    credit_ring = st.credit_ring.at[(t + consts.ret) % R, gflow].add(
        jnp.where(has_g, MTU, 0.0), mode="promise_in_bounds")
    granted = jnp.pad(st.granted, (0, 1)).at[gflow].add(
        jnp.where(has_g, MTU, 0.0), mode="promise_in_bounds")[:NF]
    rr_recv = jnp.where(has_g, (sel.astype(I32) + 1) % FRMAX, st.rr_recv)
    return st._replace(credit_ring=credit_ring, granted=granted, rr_recv=rr_recv)


def admission(dims: Dims, consts: Consts, st: SimState):
    """Send admission for every flow at the current tick, *excluding* rate
    pacing (the caller folds in the freshly accrued pacing budget; the
    leap ``horizon`` runs only for unpaced configurations, where this IS
    the full admission).  Returns ``(elig, has_retx, seq_emit, nsize)``.
    """
    NF, W, FMAX, window = dims.NF, dims.W, dims.FMAX, dims.window
    mtu_i = dims.mtu
    flow_ids = consts.flow_ids
    cc = st.cc

    started = activated(dims, consts, st)
    if window < FMAX:
        # windowed-alltoall eligibility: < window unfinished predecessors.
        # Each flow's (sender, column) is static (consts.slot_of), so the
        # eligibility is a gather from the per-sender prefix count — no
        # scatter back through flows_of.
        done_p = jnp.pad(st.done, (0, 1), constant_values=True)
        unfin = (~done_p[consts.flows_of]) & (consts.flows_of < NF)  # [N, FMAX]
        prior_unfin = jnp.cumsum(unfin, axis=1) - unfin.astype(I32)
        started &= prior_unfin[consts.src, consts.slot_of] < window

    is_retx = st.sent[0, :NF] == 3
    has_retx = jnp.any(is_retx, axis=1)
    retx_slot = jnp.argmax(is_retx, axis=1)
    retx_seq = st.sent[1, flow_ids, retx_slot]
    new_seq = st.next_seq
    new_slot = new_seq % W
    new_ok = (new_seq * mtu_i < consts.size) & \
        (st.sent[0, flow_ids, new_slot] == 0)
    seq_emit = jnp.where(has_retx, retx_seq, new_seq)
    # flow_ids is the exact [0, NF) iota, so pkt_size's defensive flow clip
    # (and its gather) is unnecessary — size the packet directly.
    nsize = jnp.clip(consts.size - seq_emit * mtu_i, 0, mtu_i).astype(F32)
    win_ok = st.unacked + nsize <= cc.cwnd
    credit_ok = True
    if dims.credit_based:
        credit_ok = (cc.credits >= nsize) | (cc.spec_budget >= nsize)
    elig = started & (has_retx | new_ok) & win_ok & credit_ok & (nsize > 0)
    return elig, has_retx, seq_emit, nsize


def sends(dims: Dims, consts: Consts, st: SimState, arb=None) -> SimState:
    """Phase 5: one packet per NIC per tick, arbitration + admission.

    ``arb`` is the backend-resolved round-robin arbitration callable
    (``kernels/enqueue_arb/ops.get``); ``None`` means the pure-jnp
    reference."""
    if arb is None:
        from . import enqueue_arb_ops as _arb_ops
        arb = _arb_ops.rr_pick
    t = st.now
    m = st.m
    NF, N, NQ, L, W = dims.NF, dims.N, dims.NQ, dims.L, dims.W
    FMAX = dims.FMAX
    mtu_i = dims.mtu
    flow_ids = consts.flow_ids
    cc = st.cc

    pace = st.pace_accum
    if dims.paced:
        pace = jnp.minimum(pace + cc.pacing_rate, 4.0 * float(mtu_i))

    elig, has_retx, seq_emit, nsize = admission(dims, consts, st)
    if dims.paced:
        elig &= pace >= nsize

    # per-sender round-robin arbitration (one packet per NIC per tick)
    if FMAX == 1:
        # at most one flow per sender: arbitration is the identity
        has_s = jnp.pad(elig, (0, 1))[consts.flows_of[:, 0]]
        sflow = jnp.where(has_s, consts.flows_of[:, 0], NF)
        rr_send = st.rr_send
    else:
        E = jnp.pad(elig, (0, 1))[consts.flows_of]               # [N, FMAX]
        has_s, sel = arb(E, st.rr_send, FMAX)
        sflow = jnp.where(has_s, consts.flows_of[consts.node_ids, sel], NF)
        rr_send = jnp.where(has_s, (sel.astype(I32) + 1) % FMAX, st.rr_send)

    # flow f emits iff its own sender selected it (gather, not scatter)
    emit_mask = sflow[consts.src] == flow_ids
    lb, entropy = reps.on_send(dims.lb_mode, consts.lb, st.lb, emit_mask,
                               seq_emit, flow_ids, t)
    first_q = route_first_hop(dims, consts, entropy)

    # place on the wire — one dynamic-update-slice over the NIC emitter
    # rows [NQ, NE) at the (uniform) sender latency slot; zeros for idle
    # NICs are exact because the slot holds no live packet (see the
    # exclusivity argument in fabric.departures)
    sf = jnp.clip(sflow, 0, NF - 1)
    spay = jnp.where(has_s[:, None], jnp.stack([
        has_s.astype(I32),
        first_q[sf],
        sflow,
        seq_emit[sf],
        entropy[sf],
        jnp.zeros((N,), I32),
        jnp.broadcast_to(t, (N,)),
    ], axis=1), 0)
    infl = st.infl.at[(t + consts.lat_send) % L, NQ:].set(spay)

    # sent-ring bookkeeping: a one-hot masked write of the [3, NF, W] body
    # (the emitting flow's slot is seq_emit % W) folded into one contiguous
    # slice update — XLA:CPU fuses the compare+select pass, which beats the
    # historical packed scatter by an order of magnitude at 512-node scale;
    # non-emitting rows copy through unchanged and the write-off row NF is
    # never touched, so an event-free tick leaves the ring bitwise
    # unchanged — the property time leaping relies on
    hit = emit_mask[:, None] & \
        (jnp.arange(W, dtype=I32)[None, :] == (seq_emit % W)[:, None])
    body = st.sent[:, :NF]
    sent = st.sent.at[:, :NF].set(jnp.stack([
        jnp.where(hit, 1, body[0]),
        jnp.where(hit, seq_emit[:, None], body[1]),
        jnp.where(hit, t, body[2]),
    ]))
    is_new_send = emit_mask & ~has_retx
    next_seq = st.next_seq + is_new_send.astype(I32)
    m = m._replace(n_retx=m.n_retx + jnp.sum((emit_mask & has_retx).astype(I32)))

    spend = jnp.where(emit_mask, nsize, 0.0)
    if dims.credit_based:
        use_credit = cc.credits >= nsize
        cc = cc._replace(
            credits=cc.credits - spend * use_credit,
            spec_budget=cc.spec_budget - spend * (~use_credit),
        )
    if dims.paced:
        pace = pace - spend

    return st._replace(
        infl=infl, sent=sent,
        next_seq=next_seq, rr_send=rr_send, pace_accum=pace, cc=cc, lb=lb, m=m,
    )


def horizon(dims: Dims, consts: Consts, st: SimState):
    """Ticks until phases 4-5 next do work (DESIGN.md Sec. 6.3).

    0 while any flow passes send admission (its NIC emits this tick) or —
    for credit-based algorithms — any receiver owes a grant: both
    predicates are functions of state that only *eventful* ticks mutate,
    so between events the only thing that can flip them is a flow-start
    deadline, which bounds the leap.  Dependency releases (DESIGN.md Sec.
    11) need no extra term: ``admission`` (shared here bit-for-bit, the
    leap clamp) gates on ``sender.activated``, and a parent's threshold
    crossing rides on a delivery — an arrival the fabric horizon already
    bounds.  Never traced for paced configurations (``Dims.leap`` is
    forced off there — the pacing budget accrues every tick).
    """
    t = st.now
    elig, _, _, _ = admission(dims, consts, st)
    h = jnp.where(jnp.any(elig), 0, HORIZON_INF)
    if dims.credit_based:
        h = jnp.minimum(
            h, jnp.where(jnp.any(_grant_demand(dims, consts, st)),
                         0, HORIZON_INF))
    unstarted = t < consts.t_start
    h_start = jnp.min(jnp.where(unstarted, consts.t_start - t, HORIZON_INF))
    return jnp.minimum(h, h_start)
