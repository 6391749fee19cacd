"""Phases 1-2 of the tick — the switching fabric.

  1. ``departures``: dequeue head per port, RED dequeue-marking, route,
     blackhole on failed links, place on the wire
  2. ``arrivals``:  packets landing now -> enqueue (trim/drop on overflow)
     or deliver (receiver dedupe, ACK generation)

Both are pure ``(Dims, Consts, SimState) -> SimState``; they communicate
with the rest of the pipeline only through ``SimState`` fields (the wire
ring ``infl``, the delayed control rings, and the receiver ledgers).
Routing is purely functional over the per-emitter constants in ``Consts``.

``horizon`` is the phases' next-event reduction for the engine's
event-horizon time leaping (DESIGN.md Sec. 6.3): every delay ring keeps the
invariant that a *valid* entry is a genuinely in-flight event (slots are
zeroed when read), so "ticks until this phase next does work" is a cheap
reduction over the live slots.
"""

from __future__ import annotations

from . import np32 as jnp

from . import faults, hashing
from .metrics import GOODPUT_BINS
from .state import HORIZON_INF, Consts, Dims, SimState, pkt_size

I32 = jnp.int32
F32 = jnp.float32


def route_switch(dims: Dims, consts: Consts, sw, d, ent):
    """Table-driven next hop at switch ``sw`` for a packet to node ``d``
    carrying path entropy ``ent`` (all broadcastable arrays).

    *Down* when ``d`` lies in the switch's subtree interval: the
    run-length lookup ``dn_base[sw] + d // dn_stride[sw]`` (every tier's
    down ports cover the subtree in equal-length node runs — see
    ``topology.build_topology`` — so two [NSW] vectors replace the dense
    ``[NSW, N]`` table this used to gather through).  *Up* otherwise: an
    ECMP hash of the entropy with the per-switch salt selects among the
    switch's contiguous run of equal-cost up ports — at the T0 tier that
    picks the spine/agg, at the T1 tier of a three-tier tree the same
    hash (a different salt) picks the core path (paper Sec. 3.6)."""
    down = (d >= consts.sw_lo[sw]) & (d < consts.sw_hi[sw])
    cnt = consts.sw_up_cnt[sw]
    h = (hashing.hash2(ent.astype(jnp.uint32), consts.sw_salt[sw])
         % jnp.maximum(cnt, 1).astype(jnp.uint32)).astype(I32)
    return jnp.where(down, consts.dn_base[sw] + d // consts.dn_stride[sw],
                     consts.sw_up_base[sw] + h)


def route_from_queue(dims: Dims, consts: Consts, flow, ent):
    """Next queue for the packet departing each fabric port (``flow`` /
    ``ent`` are [NQ], one head-of-line packet per port; negative ids encode
    delivery to node -(id+1)).  Each port's wire feeds the switch
    ``consts.nbr_q`` names; the last N ports (``consts.edge_q``) feed host
    NICs and deliver.

    Same decision as :func:`route_switch` at ``sw = nbr_q``, but reading
    the per-queue tables ``q_*`` (the switch tables pre-gathered through
    ``nbr_q`` at derive time) — the only per-tick gather left is the
    flow -> dst lookup, which genuinely varies."""
    d = consts.dst[jnp.clip(flow, 0, dims.NF - 1)]
    down = (d >= consts.q_lo) & (d < consts.q_hi)
    h = (hashing.hash2(ent.astype(jnp.uint32), consts.q_salt)
         % jnp.maximum(consts.q_up_cnt, 1).astype(jnp.uint32)).astype(I32)
    nxt = jnp.where(down, consts.q_dn_base + d // consts.q_dn_stride,
                    consts.q_up_base + h)
    return jnp.where(consts.edge_q, -(d + 1), nxt)


def route_first_hop(dims: Dims, consts: Consts, ent):
    """First queue for a fresh packet of *every* flow (``ent`` is the
    [NF] per-flow entropy) — the tick's hot path.  The subtree test and
    the down queue are workload constants (``f_down`` / ``f_dn_q``), so
    the whole decision is a gather-free select over [NF] vectors — only
    the ECMP hash runs per tick."""
    h = (hashing.hash2(ent.astype(jnp.uint32), consts.f_salt)
         % jnp.maximum(consts.f_up_cnt, 1).astype(jnp.uint32)).astype(I32)
    return jnp.where(consts.f_down, consts.f_dn_q, consts.f_up_base + h)


def route_from_sender(dims: Dims, consts: Consts, f, ent):
    """First queue for a fresh packet of flow ``f`` carrying entropy
    ``ent``: the routing decision of the sender's rack switch (same-rack
    shortcut straight to the edge port, ECMP uplink hash otherwise).
    ``f`` and ``ent`` broadcast (the routing property tests walk
    [NF, 1] x [1, E] grids); the tick itself uses the all-flows
    :func:`route_first_hop`.  Same per-flow tables, same ints."""
    h = (hashing.hash2(ent.astype(jnp.uint32), consts.f_salt[f])
         % jnp.maximum(consts.f_up_cnt[f], 1).astype(jnp.uint32)
         ).astype(I32)
    return jnp.where(consts.f_down[f], consts.f_dn_q[f],
                     consts.f_up_base[f] + h)


def route_step(dims: Dims, consts: Consts, q, d, ent):
    """Next queue after departing port ``q`` toward node ``d`` — the
    single-port form of :func:`route_from_queue` (tests/tools walk paths
    with it; the tick itself uses the all-ports form)."""
    nxt = route_switch(dims, consts, consts.nbr_q[q], d, ent)
    return jnp.where(consts.edge_q[q], -(d + 1), nxt)


def departures(dims: Dims, consts: Consts, st: SimState) -> SimState:
    """Phase 1: one head-of-line packet per active port onto the wire."""
    t = st.now
    m = st.m
    NQ, CAP, L = dims.NQ, dims.CAP, dims.L
    B = dims.QE                                       # core/edge port split

    qidx = consts.qidx
    # fault schedule: per-port service period as a function of t (1 =
    # healthy, 0 = dead, k > 1 = degraded; faults.port_period evaluates
    # the compiled transition tables — gated statically so no-fault
    # configs keep the historical fault-free graph).  The modulus stays
    # on the absolute tick, so a lowered legacy fault is bit-identical
    # to the historical service_period evaluation.
    if dims.FK or dims.flapped:
        per = faults.port_period(dims, consts, t)
        svc = jnp.where(per > 1, (t % jnp.maximum(per, 1)) == 0, True)
    else:
        svc = True
    active = (st.q_size[:NQ] > 0) & svc
    head = st.q_head[:NQ]
    hf = st.q_fields[qidx, head]                      # [NQ, 5]
    d_flow, d_seq, d_ent, d_ecn, d_ts = (hf[:, i] for i in range(5))
    # RED marking at dequeue (paper Sec. 2.1 / 3.5)
    qsz = st.q_size[:NQ].astype(F32)
    pmark = jnp.clip((qsz - consts.kmin) / consts.kspan, 0.0, 1.0)
    mark = hashing.uniform01(t * jnp.int32(131071) + qidx,
                             jnp.int32(0xECD) + st.salt) < pmark
    d_ecn = d_ecn | (mark & active).astype(I32)
    if dims.FK or dims.flapped:
        black = (per == 0) & active
    else:
        black = jnp.zeros((NQ,), bool)
    emit = active & ~black
    next_q = route_from_queue(dims, consts, d_flow, d_ent)
    q_head = st.q_head.at[:NQ].set(jnp.where(active, (head + 1) % CAP, head))
    q_size = st.q_size.at[:NQ].add(-active.astype(I32))
    payload = jnp.where(emit[:, None], jnp.stack(
        [emit.astype(I32), next_q, d_flow, d_seq, d_ent, d_ecn, d_ts],
        axis=1), 0)
    # Wire placement as two dynamic-update-slices, not a scatter: latency
    # is uniform within the switch-facing ports ([0, QE): every up/down
    # tier) and the edge ports ([QE, NQ): t0_down), and each emitter's target slot
    # (t + lat) % L holds nothing still live at tick t (only this emitter
    # writes its column, and whatever it wrote there last wrap landed
    # L - lat ticks ago) — so blanket-writing zeros for inactive ports is
    # exact, and arrivals never needs to zero a drained slot.
    infl = st.infl.at[(t + consts.lat_core) % L, :B].set(payload[:B])
    infl = infl.at[(t + consts.lat_edge) % L, B:NQ].set(payload[B:])
    m = m._replace(n_black=m.n_black + jnp.sum(black.astype(I32)))
    return st._replace(q_head=q_head, q_size=q_size, infl=infl, m=m)


def arrivals(dims: Dims, consts: Consts, st: SimState,
             enqueue=None) -> SimState:
    """Phase 2: land this tick's wire slot — deliver at the edge (dedupe,
    ACK generation) or enqueue mid-fabric (trim/drop on overflow).

    ``enqueue`` is the backend-resolved enqueue-rank callable
    (``kernels/enqueue_arb/ops.get``); ``None`` means the pure-jnp
    reference (the engine passes the ``SimConfig.fabric_backend``
    resolution)."""
    t = st.now
    m = st.m
    NF, NQ, NE, N = dims.NF, dims.NQ, dims.NE, dims.N
    CAP, L, R = dims.CAP, dims.L, dims.R

    arr = st.infl[t % L]                               # [NE, 7]
    # zero the slot once read: the wire ring then only ever holds live
    # packets, which is what makes `horizon`'s occupied-slot reduction (and
    # therefore time leaping over the skipped blanket rewrites) sound
    infl = st.infl.at[t % L].set(0)

    # ---- deliveries ----
    # Only the t0_down ports (emitter rows [QE, QE+N), one per node, in
    # node order) can deliver, so the delivery path works on that N-row
    # slice: row i delivers to node i.
    lo = dims.QE
    darr = arr[lo:lo + N]
    deliver = (darr[:, 0] == 1) & (darr[:, 1] < 0)
    d_flow, d_seq, d_ent, d_ecn, d_ts = (darr[:, i] for i in range(2, 7))
    # Receiver ledgers in the *flow-major* view: flow f's packets can only
    # ever land at node dst[f], and each node delivers at most one packet
    # per tick — so one gather by ``dst`` plus a flow-id check replaces the
    # historical per-node scatters into bitmap/goodput with dense [NF, *]
    # elementwise updates (row f of the bitmap is flow f's own; the MAXW
    # word axis is resolved with a one-hot select, never a gather).
    dview = darr[consts.dst]                           # [NF, 7]
    del_f = (dview[:, 0] == 1) & (dview[:, 1] < 0) & \
        (dview[:, 2] == consts.flow_ids)
    seq_f = jnp.where(del_f, dview[:, 3], 0)
    word_f, bit_f = seq_f // 32, seq_f % 32
    wsel = word_f[:, None] == jnp.arange(dims.MAXW, dtype=I32)  # [NF, MAXW]
    bm = st.bitmap[:NF]
    old_w = jnp.sum(jnp.where(wsel, bm, 0), axis=1)
    isnew_f = del_f & (((old_w >> bit_f) & 1) == 0)
    bitmap = st.bitmap.at[:NF].set(
        bm + jnp.where(wsel & isnew_f[:, None],
                       (1 << bit_f).astype(I32)[:, None], 0))
    # pkt_size at the all-flows identity: flow f's size is consts.size[f],
    # so the defensive flow clip (and its gather by the traced flow_ids
    # iota) drops out — size the packet directly (bitwise the same ints)
    psz_f = jnp.where(isnew_f,
                      jnp.clip(consts.size - seq_f * dims.mtu, 0, dims.mtu),
                      0)
    goodput = st.goodput + psz_f
    newly_done = (goodput >= consts.size) & ~st.done
    done = st.done | newly_done
    fct = jnp.where(newly_done, t + consts.ret - consts.t_start, st.fct)
    # ACK generation (echoes entropy + ECN + timestamp; priority path).
    # The return delay is constant (state.derive), so slot (t+ret) % R is
    # exclusively this tick's: write all N receiver rows in one
    # dynamic-update-slice, zeros where nothing was delivered.
    ack_payload = jnp.where(deliver[:, None], jnp.stack(
        [deliver.astype(I32), d_flow, d_seq, d_ecn, d_ent, d_ts], axis=1), 0)
    ack_ring = st.ack_ring.at[(t + consts.ret) % R].set(ack_payload)
    # recovery metrics: binned goodput history for dip/TTR
    # analysis, plus bytes delivered while the fault schedule is active.
    # Both only accrue on delivery ticks (zero on event-free ticks), so
    # they are leap-exact for free; both live behind the same static
    # fault gate so fault-free configs keep the historical graph.
    dbytes = jnp.sum(psz_f).astype(F32)
    goodput_hist = m.goodput_hist
    delivered_bytes_fault = m.delivered_bytes_fault
    if dims.FK or dims.flapped:
        gbin = jnp.minimum(t // consts.goodput_bin, GOODPUT_BINS - 1)
        goodput_hist = m.goodput_hist + jnp.where(
            jnp.arange(GOODPUT_BINS, dtype=I32) == gbin, dbytes, 0.0)
        delivered_bytes_fault = m.delivered_bytes_fault + jnp.where(
            faults.fault_active(dims, consts, t), dbytes, 0.0)
    m = m._replace(
        delivered_pkts=m.delivered_pkts + jnp.sum(deliver.astype(I32)),
        delivered_bytes=m.delivered_bytes + dbytes,
        goodput_hist=goodput_hist,
        delivered_bytes_fault=delivered_bytes_fault,
    )

    # ---- enqueues (sort-free scatter with capacity + trim) ----
    # Only the enqueue-capable emitters (wire feeds a switch: every core
    # port + every sender NIC; the t0_down ports above deliver and never
    # enqueue) take part, so the whole path runs on the compact [EQ] axis
    # gathered through ``consts.enq_ids`` — every scatter below shrinks
    # from NE to EQ rows, the dominant cost at fabric scale.
    #
    # Same-queue arrivals must land in fixed emitter order (the semantics
    # the old stable-argsort ranking gave).  The rank of emitter e within
    # its destination-queue group is the count of emitters e' < e with the
    # same destination; since same-queue emitters always feed the same
    # switch, the compare+reduce runs per switch fan-in group over the
    # static ``in_tbl``/``in_pos`` tables — O(NSW * DMAX^2) instead of the
    # historical global [NE, NE] pass, bit-for-bit the same ranks (the
    # compact enumeration is id-ascending, so group slot order is
    # unchanged; kernels/enqueue_arb — the jnp reference and the Pallas
    # kernel are interchangeable backends).
    if enqueue is None:
        from . import enqueue_arb_ops as _arb_ops
        enqueue = _arb_ops.enqueue_rank
    earr = arr[consts.enq_ids]                         # [EQ, 7]
    e_dstq, e_flow, e_seq, e_ent, e_ecn, e_ts = (
        earr[:, i] for i in range(1, 7))
    enq = (earr[:, 0] == 1) & (e_dstq >= 0)
    q_head, q_size = st.q_head, st.q_size
    edst = jnp.where(enq, e_dstq, NQ)
    acc, pos, q_counts = enqueue(consts.in_tbl, consts.in_pos,
                                 consts.sw_of_q, edst, q_head, q_size,
                                 CAP, NQ)
    row = jnp.where(acc, edst, NQ)
    posw = jnp.where(acc, pos, 0)
    # (indices are NOT unique: every non-accepted emitter collapses onto
    # the write-off cell (NQ, 0), which is never read — the payload is
    # masked to zero there so the cell stays constant and an event-free
    # tick leaves the whole array bitwise unchanged, the property time
    # leaping relies on)
    q_fields = st.q_fields.at[row, posw].set(
        jnp.where(acc[:, None],
                  jnp.stack([e_flow, e_seq, e_ent, e_ecn, e_ts], axis=1), 0),
        mode="promise_in_bounds")
    # per-queue accepted counts come out of the fan-in groups (a dense
    # compare+reduce in the ops layer), not a segment_sum scatter
    q_size = q_size.at[:NQ].add(q_counts)
    rej = (edst < NQ) & ~acc
    # trim (paper: only when the buffer is full) or drop
    rflow = jnp.where(rej, e_flow, NF)
    rej_pkt = pkt_size(dims, consts, e_flow, e_seq)
    rej_bytes_i = jnp.where(rej, rej_pkt, 0)
    trim_seen = st.trim_seen
    if dims.credit_based:
        # receiver-side trim visibility (EQDS: trimmed headers reach the
        # receiver, which re-schedules the pull — paper Sec. 2.2); only
        # the credit grants read it, so sender-based algorithms skip it.
        trim_seen = st.trim_seen.at[rflow].add(
            rej_bytes_i.astype(F32), mode="promise_in_bounds")
    if dims.trimming:
        W, WW = dims.W, dims.WW
        # one packed update feeds the whole delayed trim ledger: count,
        # bytes (exact in i32), and the WW per-slot loss-bitmap words.
        # The trim notification delay is a scalar constant, so every
        # rejection of this tick lands in ONE ring slot: scatter the
        # per-emitter updates into a flow-major [NF+1, 2+WW] staging row
        # (1-D indices — far cheaper than the historical 2-D-indexed
        # scatter into the ring) and fold it in with a single slice add
        # (adding the all-zero rows of idle flows is bitwise a no-op, the
        # property time leaping relies on).
        wslot = (e_seq % W) // 32
        wbit = (e_seq % W) % 32
        words = jnp.where(
            rej[:, None] & (wslot[:, None] == jnp.arange(WW, dtype=I32)),
            (1 << wbit)[:, None].astype(I32), 0)
        upd = jnp.concatenate(
            [rej.astype(I32)[:, None], rej_bytes_i[:, None], words], axis=1)
        staged = jnp.zeros((NF + 1, 2 + WW), I32).at[rflow].add(
            upd, mode="promise_in_bounds")
        trim_ring = st.trim_ring.at[(t + consts.trim_delay) % R].add(staged)
        m = m._replace(n_trim=m.n_trim + jnp.sum(rej.astype(I32)))
    else:
        trim_ring = st.trim_ring
        m = m._replace(n_drop=m.n_drop + jnp.sum(rej.astype(I32)))

    return st._replace(
        infl=infl, bitmap=bitmap, goodput=goodput, done=done, fct=fct,
        ack_ring=ack_ring, q_fields=q_fields, q_size=q_size,
        trim_seen=trim_seen, trim_ring=trim_ring, m=m,
    )


def horizon(dims: Dims, consts: Consts, st: SimState):
    """Ticks until phases 1-2 next do work (DESIGN.md Sec. 6.3).

    0 while any port holds a packet — an occupied port departs (or is
    fault-serviced/blackholed) on a tick-by-tick schedule, so the fabric is
    only leapable once every queue is drained.  Otherwise the next event is
    the earliest occupied wire slot landing: ``arrivals`` reads slot
    ``t % L``, so an entry parked in slot ``s`` lands in ``(s - t) mod L``
    ticks (exact — the wire ring is zeroed on read, so valid entries are
    exactly the packets in flight).
    """
    t = st.now
    busy = jnp.any(st.q_size[:dims.NQ] > 0)
    live = jnp.any(st.infl[:, :, 0] == 1, axis=1)                  # [L]
    dist = (consts.iota_l - t) % dims.L
    h_wire = jnp.min(jnp.where(live, dist, HORIZON_INF))
    h = jnp.where(busy, 0, h_wire)
    if dims.FK or dims.flapped:
        # clamp every leap to the next fault-schedule transition: over
        # [t, t + h) every port's service period is then constant, so a
        # leap can never jump across a fail/degrade/repair/flap edge
        h = jnp.minimum(h, faults.transition_horizon(dims, consts, t))
    return h
