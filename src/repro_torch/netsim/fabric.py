"""Phases 1-2 of the tick — the switching fabric.

  1. ``departures``: dequeue head per port, RED dequeue-marking, route,
     blackhole on failed links, place on the wire
  2. ``arrivals``:  packets landing now -> enqueue (trim/drop on overflow)
     or deliver (receiver dedupe, ACK generation)

Both are ``(Dims, LaneConsts, SimState, Tick) -> SimState`` on a lane
batch (``state.LaneConsts``, ``kernels.lanes.Tick``: every state leaf
``[L, ...]``, each lane at its own tick); they communicate with the rest
of the pipeline only through ``SimState`` fields (the wire ring ``infl``,
the delayed control rings, and the receiver ledgers).

Each runs the whole phase in one call of a backend-resolved callable.
``departures`` calls ``kernels/departures``: the fused CUDA kernel on the
card (the RED flip, the ``red_mark`` kernel's function, inside it), its
plain version ``departures_ref`` otherwise (``SimConfig.departures_backend
="plain"``: the earlier design, the phase in PyTorch).  ``arrivals`` calls
``kernels/arrivals``: the fused CUDA kernel on the card, its plain version
``arrivals_ref`` otherwise, or under ``SimConfig.fabric_backend="split"``
the earlier design, ``arrivals_ref`` with the ``enqueue_rank`` kernel in
it.

The rings (``infl``, ``ack_ring``, ``trim_ring``, ``q_fields``), the
queue heads and sizes, the receiver ledgers (``bitmap``, ``goodput``,
``done``, ``fct``, ``trim_seen``) and the counters the phases add to are
updated in place, which saves copying megabytes a tick: a state passed to
a phase is consumed, as the reference's run loops consume (donate) theirs.

``horizon`` is the phases' next-event reduction for event-horizon time
leaping (DESIGN.md Sec. 6.3), one per lane: every delay ring keeps the
invariant that a *valid* entry is a genuinely in-flight event (slots are
zeroed when read).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.arrivals import ref as arrivals_ref
from repro_torch.kernels.departures import ref as departures_ref
from repro_torch.netsim import faults
from repro_torch.kernels.lanes import Tick
from repro_torch.netsim.state import HORIZON_INF, Clock, Consts, Dims, LaneConsts, SimState

_ecmp = departures_ref.ecmp


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
    ``q_*``; the last N ports (``consts.edge_q``) feed host NICs.  The
    departures phase's own routing (``departures_ref.route``), which reads
    the same tables under the same names."""
    return departures_ref.route(consts, flow, ent)


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
    every port at tick ``t``, bool [NQ], before the ``active`` guard: the
    departures phase's flip (``departures_ref.red_flip``).

    The same function as the ``red_mark`` kernel's mark
    (``kernels/red_mark``) wherever ``kspan`` equals that kernel's
    ``max(kmax - kmin, 1e-6)``, with the salt ``0xECD + st.salt``."""
    return departures_ref.red_flip(st.q_size[:dims.NQ], consts.qidx, consts.kmin,
                                   consts.kspan, t, st.salt + departures_ref.RED_SALT)


def departures_flags(dims: Dims) -> departures_ref.Flags:
    """The run's constants that shape the departures phase."""
    return departures_ref.Flags(qe=dims.QE, fk=dims.FK, flapped=dims.flapped)


# the departures operands the run's constants hold, under the same names
_DEPARTURES_CONSTS = tuple(n for n in departures_ref.Operands._fields if n not in (
    "q_fields", "q_head", "q_size", "infl", "n_black", "salt"))


def departures_operands(consts: Consts, st: SimState) -> departures_ref.Operands:
    """The departures phase's tensors: the run's constants and the state's
    buffers (updated in place by the phase)."""
    return departures_ref.Operands(
        q_fields=st.q_fields, q_head=st.q_head, q_size=st.q_size, infl=st.infl,
        n_black=st.m.n_black, salt=st.salt,
        **{n: getattr(consts, n) for n in _DEPARTURES_CONSTS})


def departures(dims: Dims, c: LaneConsts, st: SimState, k: Tick, *,
               run, lat: departures_ref.Lat, fl: departures_ref.Flags) -> SimState:
    """Phase 1: one head-of-line packet per active port onto the wire, in
    one call of ``run`` (the backend resolved by ``kernels/departures/
    ops.get``) for every lane, which updates the state's buffers in place."""
    del dims
    run(k, lat, fl, departures_operands(c.l, st))
    return st


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


def arrivals(dims: Dims, c: LaneConsts, st: SimState, k: Tick, *,
             run, trim_delay: int, fl: arrivals_ref.Flags) -> SimState:
    """Phase 2: land each lane's wire slot of its tick — deliver at the edge
    (dedupe, ACK generation) or enqueue mid-fabric (trim/drop on overflow)
    — in one call of ``run`` (the backend resolved by ``kernels/arrivals/
    ops.get``) for every lane, which updates the state's buffers in place."""
    active = faults.fault_active(dims, c.b, k.now[:, None]) if fl.faulty else None
    run(k, trim_delay, fl, operands(c.l, st, active), c.l.goodput_bin)
    return st


def horizon(dims: Dims, consts: Consts, st: SimState, t):
    """Ticks until phases 1-2 next do work (DESIGN.md Sec. 6.3), one per
    lane (``t`` the lanes' ticks as an i32 ``[L, 1]`` column, ``consts``
    in ``LaneConsts.b`` form): 0 while any port holds a packet, else the
    earliest occupied wire slot's landing distance ``(s - t) mod L``; with
    a fault schedule, never past its next transition (no leap crosses a
    fail/degrade/repair/flap edge)."""
    busy = torch.any(st.q_size[..., :dims.NQ] > 0, dim=-1)
    live = torch.any(st.infl[..., 0] == 1, dim=-1)                  # [.., L]
    dist = torch.remainder(consts.iota_l - t, dims.L)
    h_wire = torch.amin(torch.where(live, dist, HORIZON_INF), dim=-1)
    h = torch.where(busy, 0, h_wire)
    if dims.FK or dims.flapped:
        h = torch.minimum(h, faults.transition_horizon(dims, consts, t))
    return h
