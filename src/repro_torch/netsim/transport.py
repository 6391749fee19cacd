"""Phase 3 of the tick — control-plane events and transport bookkeeping.

Drains this tick's slot of the delayed control rings (ACKs, trimmed-header
notifications, loss bitmaps, EQDS credit grants), frees/loses sent-ring
slots, fires retransmission timeouts, and hands the per-flow event bundle
to the congestion-control update and the load-balancer ACK path.

``control`` runs the per-flow work in one call of the backend-resolved
``kernels/control`` callable: the fused CUDA kernel on the card (which
also runs SMaRTT's window update), its plain version ``control_ref``
otherwise.  The load balancer and the baselines' CC update take its event
buffer in PyTorch.  ``control_split`` is the earlier design, the
``ring_drain`` and ``cc_update`` kernels with the PyTorch glue around
them (``SimConfig.transport_backend="split"``).  Both update the control
rings, the sent ring and the counters in place (a state passed to a phase
is consumed).

Both run on a lane batch (``state.LaneConsts``, ``kernels.lanes.Tick``:
every state leaf ``[L, ...]``, each lane at its own tick); the PyTorch
after the fused launch writes a lane only where it is live.  The split
design runs one lane (``Sim.run``, ``Sim.step``) and refuses more.

``horizon`` reduces the same rings — plus the armed retransmission
timers — to "ticks until this phase next does work" (DESIGN.md Sec. 6.3),
one per lane.
"""

from __future__ import annotations

import torch

from repro_torch.core import registry, reps
from repro_torch.core.types import CCEvent
from repro_torch.kernels.control import ref as control_ref
from repro_torch.kernels.lanes import Tick
from repro_torch.netsim.metrics import HIST_BINS, isum
from repro_torch.netsim.state import (HORIZON_INF, Clock, Consts, Dims, LaneConsts,
                                      SimConfig, SimState, lane, tree_map)

I32 = torch.int32
F32 = torch.float32


def effective_rto(dims: Dims, consts: Consts, st: SimState):
    """Per-flow RTO with capped exponential backoff: ``rto * 2^min(
    consecutive timeouts, cap)`` (an exact power-of-two scaling); the
    plain ``consts.rto`` when backoff is off."""
    if not dims.rto_backoff_max:
        return consts.rto
    e = torch.clamp_max(st.rto_backoff, dims.rto_backoff_max)
    return torch.ldexp(torch.broadcast_to(consts.rto, e.shape), e)


def flags(cfg: SimConfig, dims: Dims) -> control_ref.Flags:
    """The run's constants that shape the fused phase.  SMaRTT's window
    update runs inside it where the CC backend is the kernel's."""
    return control_ref.Flags(
        trimming=dims.trimming, credit_based=dims.credit_based,
        rto_backoff_max=dims.rto_backoff_max,
        smartt=cfg.cc_backend == "kernel" and cfg.algo in registry.KERNEL_ALGORITHMS,
        mtu=dims.mtu, brtt_inter=dims.brtt_inter)


def operands(consts: Consts, st: SimState) -> control_ref.Operands:
    """The fused phase's tensors: the run's constants and the state's
    buffers (updated in place by the phase)."""
    m = st.m
    return control_ref.Operands(
        dst=consts.dst, size=consts.size, t_start=consts.t_start, rto=consts.rto,
        params=consts.cc, ack_ring=st.ack_ring, trim_ring=st.trim_ring,
        credit_ring=st.credit_ring, sent=st.sent, bitmap=st.bitmap, done=st.done,
        rto_backoff=st.rto_backoff, unacked=st.unacked, cc=st.cc, n_to=m.n_to,
        spurious_retx=m.spurious_retx, n_ack=m.n_ack, rtt_hist=m.rtt_hist)


def masked(k: Tick, new, old):
    """``new`` where a lane of ``k`` is live, ``old`` elsewhere, leaf by
    leaf over two trees of ``[L, ...]`` tensors (a leaf ``new`` left as it
    was is kept; with every lane live, ``new`` itself)."""
    if k.all_live:
        return new

    def pick(x, y):
        if x is y:
            return y
        return torch.where(k.live.reshape((-1,) + (1,) * (x.dim() - 1)), x, y)
    return tree_map(pick, new, old)


def control(dims: Dims, c: LaneConsts, cc_update, st: SimState, k: Tick, *,
            run, fl: control_ref.Flags) -> SimState:
    """Phase 3: the per-flow work in one call of ``run`` (the backend
    resolved by ``kernels/control/ops.get``) for every lane, then the LB
    update and, unless ``fl.smartt`` ran SMaRTT inside it, the CC update
    (``cc_update`` resolved by the registry) on its event buffer, each
    written only where a lane is live."""
    ev = run(k, fl, operands(c.l, st))
    t = k.now[:, None]
    cc = st.cc if fl.smartt else masked(k, cc_update(c.b.cc, st.cc, ev, t), st.cc)
    lb = reps.on_ack(dims.lb_mode, c.b.lb, st.lb, ev.has_ack, ev.ecn,
                     ev.ack_entropy, c.b.flow_ids, t)
    if dims.evict:
        lb = reps.on_timeout(dims.lb_mode, c.b.lb, lb, ev.n_timeouts > 0)
    return st._replace(cc=cc, lb=masked(k, lb, st.lb))


def control_split(dims: Dims, c: LaneConsts, cc_update, st: SimState, k: Tick, *,
                  drain) -> SimState:
    """Phase 3 as the earlier design runs it (:func:`control_split_one`),
    on a batch of one lane."""
    if c.n != 1:
        raise NotImplementedError(
            "the split control phase runs one lane; a lane batch runs the fused "
            "phase (ROADMAP.md Queue 1)")
    if not k.live_h[0]:
        return st
    one = lane(st, 0)
    out = control_split_one(dims, c.b, cc_update, one, Clock(k.now_h[0], 0, 0, 0, 0, 0),
                            drain=drain)
    # the leaves it updated in place stay the batch's own tensors
    return tree_map(lambda new, was, old: old if new is was else new.unsqueeze(0),
                    out, one, st)


def control_split_one(dims: Dims, consts: Consts, cc_update, st: SimState, clk: Clock, *,
                      drain) -> SimState:
    """Phase 3 as the earlier design runs it: ACK / trim / timeout / credit events ->
    transport state, CC update (``cc_update`` resolved by the registry), LB
    update, around the sent-ring drain callable ``drain``
    (``kernels/ring_drain/ops.ring_drain``)."""
    t = clk.t
    m = st.m
    NF, R = dims.NF, dims.R
    MTU = float(dims.mtu)
    flow_ids = consts.flow_ids
    dev = st.now.device

    # read this tick's ACK slot, then zero it in place (valid ACK-ring
    # entries are then exactly the ACKs in flight)
    acks = st.ack_ring[t % R].clone()                 # [N, 6]
    ack_ring = st.ack_ring
    ack_ring[t % R] = 0

    # flow-major ACK view as a gather: flow f's ACKs only come from its own
    # receiver's row, which carries the flow id
    cand = acks[consts.dst]                           # [NF, 6]
    has_ack = (cand[:, 0] == 1) & (cand[:, 1] == flow_ids)
    # field-major copy: the kernels take each per-flow field as a
    # contiguous [NF] plane
    by_flow = torch.where(has_ack[:, None], cand, 0).t().contiguous()   # [6, NF]
    ack_seq = by_flow[2]
    ack_ecn = has_ack & (by_flow[3] == 1)
    ack_ent = by_flow[4]
    ack_ts = by_flow[5]
    rtt = torch.where(has_ack, (t - ack_ts).to(F32), 0.0)
    ack_bytes = torch.where(
        has_ack,
        (consts.size - ack_seq * dims.mtu).clamp(0, dims.mtu).to(F32),
        0.0)

    tr = st.trim_ring[t % R][:NF].clone()             # [NF, 2+WW] packed
    trims = tr[:, 0].contiguous()                     # a plane for cc_update
    tbytes = tr[:, 1].to(F32)
    lbits = tr[:, 2:]                                 # row-strided view
    cred = st.credit_ring[t % R][:NF].clone()
    trim_ring = st.trim_ring
    trim_ring[t % R] = 0
    credit_ring = st.credit_ring
    credit_ring[t % R] = 0.0

    # transport: free the ACKed slot, mark trim/timeout losses, reduce the
    # per-flow timeout/spurious/outstanding counts (kernels/ring_drain)
    started_flows = (t >= consts.t_start) & ~st.done
    st_state, n_to, spur, un_pkts = drain(
        t, effective_rto(dims, consts, st), started_flows, has_ack,
        ack_seq, lbits,
        st.bitmap[:NF], st.sent[0, :NF], st.sent[1, :NF], st.sent[2, :NF])
    sent = st.sent
    sent[0, :NF] = st_state                           # in place
    m = m._replace(spurious_retx=m.spurious_retx + isum(spur))
    to_bytes = n_to.to(F32) * MTU
    m = m._replace(n_to=m.n_to + isum(n_to))

    # capped exponential RTO backoff: bump on a tick that fired timeouts,
    # reset on any ACK (on a tick with both, the reset wins)
    rto_backoff = st.rto_backoff
    if dims.rto_backoff_max:
        rto_backoff = torch.where(
            n_to > 0,
            torch.clamp_max(st.rto_backoff + 1, dims.rto_backoff_max),
            st.rto_backoff)
        rto_backoff = torch.where(has_ack, 0, rto_backoff)

    unacked = un_pkts.to(F32) * MTU

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
    # RTT histogram — one-hot reduce instead of a scatter-add
    bins = (rtt * (8.0 / dims.brtt_inter)).to(I32).clamp(0, HIST_BINS - 1)
    hist_inc = isum(
        has_ack[:, None] &
        (bins[:, None] == torch.arange(HIST_BINS, dtype=I32, device=dev)),
        dim=0)
    m = m._replace(
        rtt_hist=m.rtt_hist + hist_inc,
        n_ack=m.n_ack + isum(has_ack),
    )

    return st._replace(
        ack_ring=ack_ring, trim_ring=trim_ring, credit_ring=credit_ring,
        sent=sent, unacked=unacked, cc=cc, lb=lb, m=m,
        rto_backoff=rto_backoff,
    )


def horizon(dims: Dims, consts: Consts, st: SimState, t):
    """Ticks until phase 3 next does work (DESIGN.md Sec. 6.3), one per
    lane (``t`` the lanes' ticks as an i32 ``[L, 1]`` column, ``consts``
    in ``LaneConsts.b`` form): the nearest live control-ring slot (ACK,
    trim, and for credit-based algorithms the credit ring), or the first
    armed timeout's fire tick (``floor(rto) + 1`` ticks after the send),
    whichever comes first."""
    NF, R = dims.NF, dims.R
    dist = torch.remainder(consts.iota_r - t, R)
    live_ack = torch.any(st.ack_ring[..., 0] == 1, dim=-1)        # [.., R]
    h = torch.amin(torch.where(live_ack, dist, HORIZON_INF), dim=-1)
    if dims.trimming:
        live_trim = torch.any(st.trim_ring[..., :NF, 0] > 0, dim=-1)
        h = torch.minimum(h, torch.amin(torch.where(live_trim, dist, HORIZON_INF), dim=-1))
    if dims.credit_based:
        live_cred = torch.any(st.credit_ring[..., :NF] != 0.0, dim=-1)
        h = torch.minimum(h, torch.amin(torch.where(live_cred, dist, HORIZON_INF), dim=-1))
    started = (t >= consts.t_start) & ~st.done
    armed = (st.sent[..., 0, :NF, :] == 1) & started[..., None]   # [.., NF, W]
    fire = (st.sent[..., 2, :NF, :]
            + torch.floor(effective_rto(dims, consts, st)).to(I32)[..., None]
            + 1 - t[..., None])
    h_to = torch.amin(torch.where(armed, fire.clamp_min(0), HORIZON_INF), dim=(-2, -1))
    return torch.minimum(h, h_to)
