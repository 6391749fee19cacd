"""Plain PyTorch version of the fused control phase (``csrc/control.cu``).

``control_ref`` is the per-flow work of ``transport.control`` for one tick,
with the fused kernel's exact contract:

  1. read this tick's ACK slot through ``dst`` (a flow's ACK comes only
     from its receiver's row, which carries the flow id), its trim row
     (count, bytes, loss words) and its credit row; zero the three slots;
  2. drain the sent ring (``ring_drain_ref``: the ACK frees its slot,
     trim-notified slots become lost, timeouts fire with the spurious
     audit) and reduce the per-flow timeout, spurious and outstanding
     counts;
  3. bump or reset the capped RTO backoff;
  4. for SMaRTT (``Flags.smartt``), run the window update
     (``core.smartt.smartt_update``, the ``cc_update`` kernel's plain
     version) on the event;
  5. add the metric increments: timeouts, spurious retransmissions, ACKs
     and the RTT histogram.

It updates in place: the sent ring's state plane, ``rto_backoff``,
``unacked``, the SMaRTT planes of the CC state and the four counters (a
state passed to a phase is consumed, as the rings already are).  It
returns the event as views of one buffer (:func:`new_events`,
:func:`events`), which the load balancer and, with ``Flags.smartt`` off,
the baselines' CC update take in PyTorch.  ``control_lanes_ref`` is the
same phase on a lane batch (``kernels/lanes``: every operand ``[L, ...]``),
the kernel's contract: ``control_ref`` on each live lane at its own tick,
the other lanes left as they were, the event ``[L, NF]`` views (a lane
that is not live reads zeros).

Operation for operation the code of ``transport.control_split`` (the
glue around the ring_drain and cc_update kernels), with
``ring_drain_ref`` and ``smartt_update`` in place of the kernels.  With ``Flags.trimming`` off the
trim slot is neither read nor zeroed, and with ``Flags.credit_based`` off
the credit slot: the fabric never writes them then, so they stay zero.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.smartt import smartt_update
from repro_torch.core.types import SMARTT_FIELDS, CCEvent, CCParams, CCState
from repro_torch.kernels import lanes
from repro_torch.kernels.ring_drain.ref import ring_drain_ref

I32 = torch.int32
F32 = torch.float32

# The event buffer: one row of NF 32-bit words a field, in this order.  A
# bool field packs its NF bytes at the start of its row, so every field is
# a view of the buffer with CCEvent's dtype (no conversion on the way).
EVENT_FIELDS = (
    ("has_ack", torch.bool), ("ecn", torch.bool), ("ack_entropy", I32),
    ("rtt", F32), ("ack_bytes", F32), ("n_trims", I32), ("trim_bytes", F32),
    ("n_timeouts", I32), ("to_bytes", F32), ("unacked", F32),
    ("credit_grant", F32),
)
K = len(EVENT_FIELDS)
# the CC-state planes the SMaRTT update writes
CC_PLANES = SMARTT_FIELDS + ("ack_count",)


class Flags(NamedTuple):
    """The run's constants that shape the phase (from ``Dims``)."""

    trimming: bool        # the trim ring is live
    credit_based: bool    # the credit ring is live (EQDS)
    rto_backoff_max: int  # RTO backoff exponent cap (0 = off)
    smartt: bool          # the SMaRTT window update runs inside the phase
    mtu: int              # bytes
    brtt_inter: int       # base RTT ticks (the RTT histogram's 8 bins a brtt)


class Operands(NamedTuple):
    """The phase's tensors.  ``NF`` flows, ``N`` nodes, ring length ``R``,
    sent-ring width ``W`` (``WW = W // 32`` loss words), ``MAXW`` dedupe
    words."""

    dst: torch.Tensor          # i32 [NF]
    size: torch.Tensor         # i32 [NF] flow bytes
    t_start: torch.Tensor      # i32 [NF]
    rto: torch.Tensor          # f32 [NF]
    params: CCParams           # SMaRTT's parameters (brtt, trtt, mi per flow)
    ack_ring: torch.Tensor     # i32 [R, N, 6]; slot t % R read, then zeroed
    trim_ring: torch.Tensor    # i32 [R, NF+1, 2+WW]; likewise
    credit_ring: torch.Tensor  # f32 [R, NF+1]; likewise
    sent: torch.Tensor         # i32 [3, NF+1, W]; plane 0 updated
    bitmap: torch.Tensor       # i32 [NF+1, MAXW] receiver dedupe (read)
    done: torch.Tensor         # bool [NF] (read)
    rto_backoff: torch.Tensor  # i32 [NF]; updated when the backoff is on
    unacked: torch.Tensor      # f32 [NF]; written
    cc: CCState                # the CC_PLANES updated with Flags.smartt
    n_to: torch.Tensor         # i32 scalar counters, added to
    spurious_retx: torch.Tensor
    n_ack: torch.Tensor
    rtt_hist: torch.Tensor     # i32 [HIST_BINS], added to


def new_events(nf: int, device, n: int | None = None) -> torch.Tensor:
    """An event buffer for ``nf`` flows: i32 ``[K, nf]``, or ``[n, K, nf]``
    for ``n`` lanes."""
    return torch.empty((K, nf) if n is None else (n, K, nf), dtype=I32, device=device)


def events(buf: torch.Tensor) -> CCEvent:
    """The event buffer's rows as a ``CCEvent`` of views (no copies):
    ``[NF]`` each, or ``[L, NF]`` for a lane batch's buffer."""
    nf = buf.shape[-1]
    out = {}
    for k, (name, dt) in enumerate(EVENT_FIELDS):
        row = buf[..., k, :]
        out[name] = row.view(torch.uint8)[..., :nf].view(torch.bool) \
            if dt == torch.bool else row.view(dt)
    return CCEvent(**out)


def control_ref(t: int, fl: Flags, o: Operands) -> CCEvent:
    """One tick of the control phase's per-flow work; returns the event
    (views of its buffer) and updates ``o`` in place (module docstring)."""
    NF = o.done.shape[0]
    R, W, MAXW = o.ack_ring.shape[0], o.sent.shape[2], o.bitmap.shape[1]
    MTU = float(fl.mtu)
    dev = o.done.device
    s = t % R

    acks = o.ack_ring[s].clone()                      # [N, 6]
    o.ack_ring[s] = 0
    cand = acks[o.dst]                                # [NF, 6]
    flow_ids = torch.arange(NF, dtype=I32, device=dev)
    has_ack = (cand[:, 0] == 1) & (cand[:, 1] == flow_ids)
    by_flow = torch.where(has_ack[:, None], cand, 0).t()               # [6, NF]
    ack_seq = by_flow[2]
    ack_ecn = has_ack & (by_flow[3] == 1)
    ack_ent = by_flow[4]
    ack_ts = by_flow[5]
    rtt = torch.where(has_ack, (t - ack_ts).to(F32), 0.0)
    ack_bytes = torch.where(
        has_ack, (o.size - ack_seq * fl.mtu).clamp(0, fl.mtu).to(F32), 0.0)

    if fl.trimming:
        tr = o.trim_ring[s][:NF].clone()              # [NF, 2+WW] packed
        o.trim_ring[s] = 0
    else:
        tr = torch.zeros((NF, o.trim_ring.shape[2]), dtype=I32, device=dev)
    trims = tr[:, 0]
    tbytes = tr[:, 1].to(F32)
    lbits = tr[:, 2:]
    if fl.credit_based:
        cred = o.credit_ring[s][:NF].clone()
        o.credit_ring[s] = 0.0
    else:
        cred = torch.zeros((NF,), dtype=F32, device=dev)

    started = (t >= o.t_start) & ~o.done
    rto = o.rto
    if fl.rto_backoff_max:
        rto = torch.ldexp(o.rto, torch.clamp_max(o.rto_backoff, fl.rto_backoff_max))
    state, n_to, spur, un_pkts = ring_drain_ref(
        t, rto, started, has_ack, ack_seq, lbits, o.bitmap[:NF],
        o.sent[0, :NF], o.sent[1, :NF], o.sent[2, :NF], w=W, ww=W // 32, maxw=MAXW)
    o.sent[0, :NF] = state
    o.spurious_retx.add_(torch.sum(spur, dtype=I32))
    to_bytes = n_to.to(F32) * MTU
    o.n_to.add_(torch.sum(n_to, dtype=I32))

    # capped exponential RTO backoff: bump on a tick that fired timeouts,
    # reset on any ACK (on a tick with both, the reset wins)
    if fl.rto_backoff_max:
        rb = torch.where(n_to > 0,
                         torch.clamp_max(o.rto_backoff + 1, fl.rto_backoff_max),
                         o.rto_backoff)
        o.rto_backoff.copy_(torch.where(has_ack, 0, rb))

    unacked = un_pkts.to(F32) * MTU
    o.unacked.copy_(unacked)

    ev = CCEvent(
        has_ack=has_ack, ack_bytes=ack_bytes, ecn=ack_ecn, rtt=rtt,
        ack_entropy=ack_ent, n_trims=trims, trim_bytes=tbytes,
        n_timeouts=n_to, to_bytes=to_bytes, unacked=unacked,
        credit_grant=cred,
    )
    if fl.smartt:
        new = smartt_update(o.params, o.cc, ev, t)
        for name in CC_PLANES:
            getattr(o.cc, name).copy_(getattr(new, name))

    # RTT histogram — one-hot reduce instead of a scatter-add
    nbins = o.rtt_hist.shape[0]
    bins = (rtt * (8.0 / fl.brtt_inter)).to(I32).clamp(0, nbins - 1)
    o.rtt_hist.add_(torch.sum(
        has_ack[:, None] & (bins[:, None] == torch.arange(nbins, dtype=I32, device=dev)),
        dim=0, dtype=I32))
    o.n_ack.add_(torch.sum(has_ack, dtype=I32))

    view = events(new_events(NF, dev))
    for name, _ in EVENT_FIELDS:
        getattr(view, name).copy_(getattr(ev, name))
    return view


def control_lanes_ref(k: lanes.Tick, fl: Flags, o: Operands) -> CCEvent:
    """The phase on a lane batch: :func:`control_ref` on each live lane at
    its own tick (``k.now_h``), in place; returns the event, ``[L, NF]``
    views of one buffer (zeros for a lane that is not live)."""
    views = lanes.lane_views(lanes.thread_cache(__name__), o, k.n)
    buf = torch.zeros((k.n, K, o.done.shape[-1]), dtype=I32, device=o.done.device)
    out = events(buf)
    for i, (t, go) in enumerate(zip(k.now_h, k.live_h)):
        if go:
            ev = control_ref(t, fl, views[i])
            for name, _ in EVENT_FIELDS:
                getattr(out, name)[i].copy_(getattr(ev, name))
    return out
