"""Phase 3 of the tick — control-plane events and transport bookkeeping.

Drains this tick's slot of the delayed control rings (ACKs, trimmed-header
notifications, loss bitmaps, EQDS credit grants), frees/loses sent-ring
slots, fires retransmission timeouts, and hands the per-flow event bundle
to the congestion-control update (any registry backend: pure-jnp or the
Pallas ``cc_update`` kernel) and the load-balancer ACK path.

``horizon`` reduces the same rings — plus the armed retransmission
timers — to "ticks until this phase next does work", feeding the engine's
event-horizon time leaping (DESIGN.md Sec. 6.3).
"""

from __future__ import annotations

from . import np32 as jnp

from . import reps
from .cctypes import CCEvent
from .metrics import HIST_BINS
from .state import HORIZON_INF, Consts, Dims, SimState

I32 = jnp.int32
F32 = jnp.float32


def effective_rto(dims: Dims, consts: Consts, st: SimState):
    """Per-flow RTO with capped exponential backoff (failure recovery):
    ``rto * 2^min(consecutive timeouts, cap)``.  ``ldexp``
    scales the f32 base by an exact power of two, and the gate is static,
    so backoff-off configs keep the historical ``consts.rto`` verbatim.
    Used by both the drain and the timeout horizon — the leap must land
    exactly on the backed-off fire tick."""
    if not dims.rto_backoff_max:
        return consts.rto
    return jnp.ldexp(consts.rto,
                     jnp.minimum(st.rto_backoff, dims.rto_backoff_max))


def control(dims: Dims, consts: Consts, cc_update, st: SimState,
            drain=None) -> SimState:
    """Phase 3: ACK / trim / timeout / credit events -> transport state,
    CC update (``cc_update`` resolved by the registry), LB update.

    ``drain`` is the backend-resolved sent-ring drain callable
    (``kernels/ring_drain/ops.get``); ``None`` means the pure-jnp
    reference (the engine passes the ``SimConfig.transport_backend``
    resolution)."""
    if drain is None:
        from . import ring_drain_ops as _drain_ops
        drain = _drain_ops.ring_drain
    t = st.now
    m = st.m
    NF, N, R, W = dims.NF, dims.N, dims.R, dims.W
    MTU = float(dims.mtu)
    flow_ids = consts.flow_ids

    acks = st.ack_ring[t % R]                          # [N, 6]
    # zero the slot once read (the trim/credit rings below already do):
    # valid ACK-ring entries are then exactly the ACKs in flight, which is
    # what makes `horizon`'s occupied-slot reduction — and time leaping
    # over the skipped blanket rewrites — sound
    ack_ring = st.ack_ring.at[t % R].set(0)

    # flow-major ACK view as a *gather*: flow f's ACKs can only ever come
    # from its own receiver's row (one delivery per receiver per tick, and
    # the row carries the flow id), so ``acks[dst[f]]`` + a flow-id check
    # replaces the historical [N] -> [NF] scatter at XLA:CPU gather cost
    cand = acks[consts.dst]                            # [NF, 6]
    has_ack = (cand[:, 0] == 1) & (cand[:, 1] == flow_ids)
    by_flow = jnp.where(has_ack[:, None], cand, 0)
    ack_seq = by_flow[:, 2]
    ack_ecn = has_ack & (by_flow[:, 3] == 1)
    ack_ent = by_flow[:, 4]
    ack_ts = by_flow[:, 5]
    rtt = jnp.where(has_ack, (t - ack_ts).astype(F32), 0.0)
    # pkt_size at the all-flows identity (flow_ids is the [0, NF) iota):
    # read consts.size directly instead of gathering it through the traced
    # iota — bitwise the same ints
    ack_bytes = jnp.where(
        has_ack,
        jnp.clip(consts.size - ack_seq * dims.mtu, 0, dims.mtu).astype(F32),
        0.0)

    tr = st.trim_ring[t % R][:NF]                      # [NF, 2+WW] packed
    trims = tr[:, 0]
    tbytes = tr[:, 1].astype(F32)
    lbits = tr[:, 2:]
    cred = st.credit_ring[t % R][:NF]
    trim_ring = st.trim_ring.at[t % R].set(0)
    credit_ring = st.credit_ring.at[t % R].set(0.0)

    # transport: free the ACKed slot, mark trim/timeout losses, reduce the
    # per-flow timeout/spurious/outstanding counts — one packed drain over
    # the component-major sent ring (kernels/ring_drain; elementwise +
    # row reductions only, folded into ONE contiguous write of the state
    # component — the jnp reference and the Pallas kernel are
    # interchangeable backends)
    started_flows = (t >= consts.t_start) & ~st.done
    st_state, n_to, spur, un_pkts = drain(
        t, effective_rto(dims, consts, st), started_flows, has_ack,
        ack_seq, lbits,
        st.bitmap[:NF], st.sent[0, :NF], st.sent[1, :NF], st.sent[2, :NF])
    sent = st.sent.at[0, :NF].set(st_state)
    m = m._replace(spurious_retx=m.spurious_retx + jnp.sum(spur))
    to_bytes = n_to.astype(F32) * MTU
    m = m._replace(n_to=m.n_to + jnp.sum(n_to))

    # capped exponential RTO backoff: bump on a tick that fired timeouts,
    # reset on any ACK (an ACK proves the path is moving again; on a tick
    # with both, the reset wins).  Event-free ticks change nothing, so
    # time leaping stays exact.
    rto_backoff = st.rto_backoff
    if dims.rto_backoff_max:
        rto_backoff = jnp.where(
            n_to > 0,
            jnp.minimum(st.rto_backoff + 1, dims.rto_backoff_max),
            st.rto_backoff)
        rto_backoff = jnp.where(has_ack, 0, rto_backoff)

    unacked = un_pkts.astype(F32) * MTU

    ev = CCEvent(
        has_ack=has_ack, ack_bytes=ack_bytes, ecn=ack_ecn, rtt=rtt,
        ack_entropy=ack_ent, n_trims=trims, trim_bytes=tbytes,
        n_timeouts=n_to, to_bytes=to_bytes, unacked=unacked,
        credit_grant=cred,
    )
    cc = cc_update(consts.cc, st.cc, ev, t)
    lb = reps.on_ack(dims.lb_mode, consts.lb, st.lb, has_ack, ack_ecn, ack_ent,
                     flow_ids, t)
    if dims.evict:
        lb = reps.on_timeout(dims.lb_mode, consts.lb, lb, n_to > 0)
    # RTT histogram — one-hot reduce instead of a scatter-add ([NF, BINS]
    # fused compare+sum beats the XLA:CPU scatter loop)
    bins = jnp.clip((rtt * (8.0 / dims.brtt_inter)).astype(I32), 0, HIST_BINS - 1)
    hist_inc = jnp.sum(
        (has_ack[:, None] &
         (bins[:, None] == jnp.arange(HIST_BINS, dtype=I32))).astype(I32),
        axis=0)
    m = m._replace(
        rtt_hist=m.rtt_hist + hist_inc,
        n_ack=m.n_ack + jnp.sum(has_ack.astype(I32)),
    )

    return st._replace(
        ack_ring=ack_ring, trim_ring=trim_ring, credit_ring=credit_ring,
        sent=sent, unacked=unacked, cc=cc, lb=lb, m=m,
        rto_backoff=rto_backoff,
    )


def horizon(dims: Dims, consts: Consts, st: SimState):
    """Ticks until phase 3 next does work (DESIGN.md Sec. 6.3).

    Three delayed control rings read slot ``t % R`` and are zeroed on
    read, so a live entry in slot ``s`` is consumed in ``(s - t) mod R``
    ticks.  An armed timeout (outstanding sent-ring slot of a started,
    unfinished flow) fires at the first integer tick strictly beyond
    ``send_tick + rto`` — ``floor(rto) + 1`` ticks after the send — which
    the leap must land on exactly, not skip past.
    """
    t = st.now
    NF, R = dims.NF, dims.R
    dist = (consts.iota_r - t) % R
    live_ack = jnp.any(st.ack_ring[:, :, 0] == 1, axis=1)          # [R]
    h = jnp.min(jnp.where(live_ack, dist, HORIZON_INF))
    if dims.trimming:
        live_trim = jnp.any(st.trim_ring[:, :NF, 0] > 0, axis=1)
        h = jnp.minimum(h, jnp.min(jnp.where(live_trim, dist, HORIZON_INF)))
    if dims.credit_based:
        live_cred = jnp.any(st.credit_ring[:, :NF] != 0.0, axis=1)
        h = jnp.minimum(h, jnp.min(jnp.where(live_cred, dist, HORIZON_INF)))
    started = (t >= consts.t_start) & ~st.done
    armed = (st.sent[0, :NF] == 1) & started[:, None]               # [NF, W]
    fire = (st.sent[2, :NF]
            + jnp.floor(effective_rto(dims, consts, st)).astype(I32)[:, None]
            + 1 - t)
    h_to = jnp.min(jnp.where(armed, jnp.maximum(fire, 0), HORIZON_INF))
    return jnp.minimum(h, h_to)
