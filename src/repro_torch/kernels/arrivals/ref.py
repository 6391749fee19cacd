"""Plain PyTorch versions of the fused arrivals phase (``csrc/arrivals.cu``).

``arrivals_ref`` is ``fabric.arrivals`` for one tick on flat operands, with
the fused kernel's exact contract:

  1. read this tick's wire slot and zero it;
  2. deliveries, on the t0_down rows ``[QE, QE+N)`` (row i delivers to
     node i): each node's ACK row of this tick, written whole; the
     receiver ledgers (dedupe bitmap, goodput, done, fct) of the flow a
     row names where that flow's destination is the node; the delivered
     packets and bytes;
  3. enqueues, on the compact axis of enqueue-capable emitters: the
     same-destination rank within each switch's fan-in row, acceptance
     and ring position (``enqueue_arb``'s formulation), the accepted
     packets into their queues and the queues' sizes; every reject into
     the delayed trim ledger (count, bytes, loss words) or the drop count
     and, on the credit path, into the receiver's ``trim_seen``;
  4. the f32 metrics: one add of the tick's integer total each.

It updates its operands in place (a state passed to a phase is consumed)
and returns nothing.  ``arrivals_lanes_ref`` is the same phase on a lane
batch (``kernels/lanes``: every operand ``[L, ...]``), the kernel's
contract: ``arrivals_ref`` on each live lane at its own tick, with the
slots and goodput bin of that tick, the other lanes left as they were.  Operation for operation the reference's
``fabric.arrivals`` (``repro/netsim/fabric.py:159``) but one: on the credit
path each flow's rejected bytes are staged in integers and added to
``trim_seen`` once (the reference adds each packet in f32).  Whole packet
sizes keep ``trim_seen`` an integer, exact in f32 below 2**24, where the
two agree; the staged form does not depend on the order of the packets,
which the kernel's atomics cannot fix.

``arrivals_by_owner`` computes the same function in the kernel's own
formulation: one reader per wire row (each real slot of a switch's fan-in
row reads its emitter's row, each node its delivery row, and zeroes it),
the ranks per row, each queue's size written by its last slot, and the
ledgers per node.  Both rely on the simulator's invariants:

  * the real slots of ``in_tbl`` name each enqueue-capable emitter once,
    and ``enq_ids`` with the delivery rows partition the wire's rows
    (``state.check_wire_rows``);
  * an emitter of switch ``sw``'s fan-in row targets only queues that
    ``sw`` owns (``sw_of_q``), so each queue's writers share one row;
  * a flow is done exactly when its goodput has reached its size (every
    size is at least one byte), so only a delivery can finish a flow.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import lanes
from repro_torch.kernels.enqueue_arb import ops as enqueue_arb_ops

I32 = torch.int32
F32 = torch.float32
GOODPUT_BINS = 64
# the ACK row of a delivery: the wire row's (valid, flow, seq, ecn, ent, ts)
ACK_COLS = (0, 2, 3, 5, 4, 6)


class Flags(NamedTuple):
    """The run's constants that shape the phase (from ``Dims``/``Clock``)."""

    trimming: bool        # rejects are trimmed into the trim ledger (else dropped)
    credit_based: bool    # rejects also reach the receiver (trim_seen, EQDS)
    faulty: bool          # a fault schedule exists: the recovery metrics accrue
    mtu: int              # bytes
    qe: int               # first delivery row of the wire (the t0_down ports)
    ret: int              # ACK return delay: a flow done at t has fct t + ret - t_start
    goodput_bin: int      # ticks a goodput_hist bin


class Slots(NamedTuple):
    """This tick's ring slots."""

    wire: int             # infl slot landing now: t % L
    ack: int              # ACK slot written: (t + ret) % R
    trim: int             # trim-ledger slot added to: (t + trim_delay) % R


class Operands(NamedTuple):
    """The phase's tensors.  ``NF`` flows, ``N`` nodes, ``NQ`` queues of
    ``CAP`` packets, ``NE`` emitters (``EQ`` of them enqueue-capable) over
    ``NSW`` fan-in rows of ``DMAX`` slots, wire ring ``L``, control rings
    ``R``, ``WW`` loss words, ``MAXW`` dedupe words."""

    enq_ids: torch.Tensor      # i32 [EQ] enqueue-capable emitter ids
    in_tbl: torch.Tensor       # i32 [NSW, DMAX] compact indices, padded with EQ
    in_pos: torch.Tensor       # i32 [EQ] flat slot of each in in_tbl
    sw_of_q: torch.Tensor      # i32 [NQ] the switch owning each queue
    dst: torch.Tensor          # i32 [NF]
    size: torch.Tensor         # i32 [NF] flow bytes
    t_start: torch.Tensor      # i32 [NF]
    infl: torch.Tensor         # i32 [L, NE, 7]; slot `wire` read, then zeroed
    q_head: torch.Tensor       # i32 [NQ+1] (read)
    q_size: torch.Tensor       # i32 [NQ+1]; [:NQ] added to
    q_fields: torch.Tensor     # i32 [NQ+1, CAP, 5]; accepted packets written
    ack_ring: torch.Tensor     # i32 [R, N, 6]; slot `ack` written whole
    trim_ring: torch.Tensor    # i32 [R, NF+1, 2+WW]; slot `trim` added to
    trim_seen: torch.Tensor    # f32 [NF+1]; added to on the credit path
    bitmap: torch.Tensor       # i32 [NF+1, MAXW]
    goodput: torch.Tensor      # i32 [NF]
    done: torch.Tensor         # bool [NF]
    fct: torch.Tensor          # i32 [NF]
    delivered_pkts: torch.Tensor         # i32 scalar counters, added to
    n_trim: torch.Tensor
    n_drop: torch.Tensor
    delivered_bytes: torch.Tensor        # f32 scalar, added to
    goodput_hist: torch.Tensor           # f32 [GOODPUT_BINS]; with Flags.faulty
    delivered_bytes_fault: torch.Tensor  # f32 scalar; with Flags.faulty
    fault_active: torch.Tensor | None    # bool scalar: a port is faulted now
                                         # (read with Flags.faulty, else None)


def goodput_bin(t: int, fl: Flags) -> int:
    """The goodput_hist bin of tick ``t``."""
    return min(t // fl.goodput_bin, GOODPUT_BINS - 1)


def _ack_rows(rows, deliver):
    """The ACK rows of the delivery rows ``rows`` [N, 7], zeros where
    nothing was delivered (columns picked one by one: an index list would
    be a host-to-device copy)."""
    return torch.where(deliver[:, None], torch.stack([rows[:, k] for k in ACK_COLS], dim=1), 0)


def _isum(x, dim=None):
    return torch.sum(x, dtype=I32) if dim is None else torch.sum(x, dim=dim, dtype=I32)


def _recovery_metrics(t: int, fl: Flags, o: Operands, dbytes) -> None:
    """Binned goodput history and bytes delivered while faulted (both
    accrue on delivery ticks only, so they are leap-exact)."""
    if fl.faulty:
        bins = torch.arange(GOODPUT_BINS, dtype=I32, device=dbytes.device)
        o.goodput_hist.add_(torch.where(bins == goodput_bin(t, fl), dbytes, 0.0))
        o.delivered_bytes_fault.add_(torch.where(o.fault_active, dbytes, 0.0))


def arrivals_ref(t: int, s: Slots, fl: Flags, o: Operands, *, enqueue=None) -> None:
    """One tick of the arrivals phase; updates ``o`` in place (module
    docstring).  ``enqueue`` is the enqueue-rank callable
    (``enqueue_arb/ops.enqueue_rank``'s signature); its plain version by
    default, the ``enqueue_rank`` kernel under the split design
    (``ops.get("split")``)."""
    if enqueue is None:
        enqueue = functools.partial(enqueue_arb_ops.enqueue_rank, backend="plain")
    NF, N = o.dst.shape[0], o.ack_ring.shape[1]
    NQ, CAP = o.q_size.shape[0] - 1, o.q_fields.shape[1]
    MAXW, WW = o.bitmap.shape[1], o.trim_ring.shape[2] - 2
    W = 32 * WW
    dev = o.dst.device

    # read this tick's wire slot, then zero it: the wire ring then only
    # ever holds live packets (what `fabric.horizon` relies on)
    arr = o.infl[s.wire].clone()                      # [NE, 7]
    o.infl[s.wire] = 0

    # ---- deliveries: receiver ledgers in the flow-major view (flow f's
    # packets land only at node dst[f], one delivery a node a tick)
    darr = arr[fl.qe:fl.qe + N]
    deliver = (darr[:, 0] == 1) & (darr[:, 1] < 0)
    flow_ids = torch.arange(NF, dtype=I32, device=dev)
    dview = darr[o.dst]                               # [NF, 7]
    del_f = (dview[:, 0] == 1) & (dview[:, 1] < 0) & (dview[:, 2] == flow_ids)
    seq_f = torch.where(del_f, dview[:, 3], 0)
    word_f = torch.div(seq_f, 32, rounding_mode="floor")
    bit_f = torch.remainder(seq_f, 32)
    wsel = word_f[:, None] == torch.arange(MAXW, dtype=I32, device=dev)
    bm = o.bitmap[:NF]
    old_w = _isum(torch.where(wsel, bm, 0), dim=1)
    isnew_f = del_f & (((old_w >> bit_f) & 1) == 0)
    bm += torch.where(wsel & isnew_f[:, None], (torch.ones_like(bit_f) << bit_f)[:, None], 0)
    psz_f = torch.where(isnew_f, (o.size - seq_f * fl.mtu).clamp(0, fl.mtu), 0)
    o.goodput.add_(psz_f)
    newly_done = (o.goodput >= o.size) & ~o.done
    o.fct.copy_(torch.where(newly_done, t + fl.ret - o.t_start, o.fct))
    o.done.logical_or_(newly_done)
    # ACK generation (echoes entropy + ECN + timestamp): the slot is this
    # tick's alone, written whole
    o.ack_ring[s.ack] = _ack_rows(darr, deliver)
    dbytes = _isum(psz_f).to(F32)
    _recovery_metrics(t, fl, o, dbytes)
    o.delivered_pkts.add_(_isum(deliver))
    o.delivered_bytes.add_(dbytes)

    # ---- enqueues, on the compact [EQ] axis of enqueue-capable emitters
    earr = arr[o.enq_ids]                             # [EQ, 7]
    e_dstq, e_flow, e_seq = earr[:, 1], earr[:, 2], earr[:, 3]
    enq = (earr[:, 0] == 1) & (e_dstq >= 0)
    edst = torch.where(enq, e_dstq, NQ)
    acc, pos, q_counts = enqueue(o.in_tbl, o.in_pos, o.sw_of_q, edst, o.q_head,
                                 o.q_size, CAP, NQ)
    # every non-accepted emitter collapses onto the write-off cell (NQ, 0)
    # under a zero payload, so the cell stays zero; the accepted (row, pos)
    # pairs are distinct
    o.q_fields.index_put_(
        (torch.where(acc, edst, NQ), torch.where(acc, pos, 0)),
        torch.where(acc[:, None], earr[:, 2:7], 0))
    o.q_size[:NQ] += q_counts
    rej = (edst < NQ) & ~acc
    # trim (paper: only when the buffer is full) or drop
    rflow = torch.where(rej, e_flow, NF)
    rej_pkt = (o.size[e_flow.clamp(0, NF - 1)] - e_seq * fl.mtu).clamp(0, fl.mtu)
    rej_bytes = torch.where(rej, rej_pkt, 0)
    if fl.credit_based:
        # receiver-side trim visibility (EQDS: trimmed headers reach the
        # receiver): staged per flow in integers, one f32 add a flow
        staged = torch.zeros((NF + 1,), dtype=I32, device=dev).index_add_(0, rflow, rej_bytes)
        o.trim_seen.add_(staged.to(F32))
    if fl.trimming:
        # one packed update of the delayed trim ledger (count, bytes and
        # the WW per-slot loss words), staged flow-major with an integer
        # scatter-add (order-free) and added into the ring slot; bit 31 is
        # 1 << 31 in i32, i.e. -2**31, as in the reference
        m = torch.remainder(e_seq, W)
        wslot = torch.div(m, 32, rounding_mode="floor")
        wbit = torch.remainder(m, 32)
        words = torch.where(
            rej[:, None] & (wslot[:, None] == torch.arange(WW, dtype=I32, device=dev)),
            (torch.ones_like(wbit) << wbit)[:, None], 0)
        upd = torch.cat([rej.to(I32)[:, None], rej_bytes[:, None], words], dim=1)
        staged = torch.zeros((NF + 1, 2 + WW), dtype=I32, device=dev)
        staged.index_add_(0, rflow, upd)
        o.trim_ring[s.trim] += staged
        o.n_trim.add_(_isum(rej))
    else:
        o.n_drop.add_(_isum(rej))


def slots(t: int, l: int, r: int, ret: int, trim_delay: int) -> Slots:
    """The ring slots of tick ``t``."""
    return Slots(wire=t % l, ack=(t + ret) % r, trim=(t + trim_delay) % r)


def arrivals_lanes_ref(k: lanes.Tick, trim_delay: int, fl: Flags, o: Operands, gbin,
                       *, enqueue=None) -> None:
    """The phase on a lane batch, in place: :func:`arrivals_ref` on each
    live lane at its own tick (``k.now_h``), with that tick's slots and
    the lane's goodput bin width ``gbin`` (i32 ``[L]``, read on the host
    once per tensor)."""
    host = lanes.thread_cache(__name__ + ".gbin")
    if host.get("of") is not gbin:
        host.update(of=gbin, bins=gbin.tolist())
    l, r = o.infl.shape[-3], o.ack_ring.shape[-3]
    views = lanes.lane_views(lanes.thread_cache(__name__), o, k.n)
    for i, (t, go) in enumerate(zip(k.now_h, k.live_h)):
        if go:
            arrivals_ref(t, slots(t, l, r, fl.ret, trim_delay),
                         fl._replace(goodput_bin=host["bins"][i]), views[i], enqueue=enqueue)


def arrivals_by_owner(t: int, s: Slots, fl: Flags, o: Operands) -> None:
    """``arrivals_ref``'s function in the fused kernel's formulation (module
    docstring): one reader per wire row, per switch row and per node."""
    NF, N = o.dst.shape[0], o.ack_ring.shape[1]
    NQ, CAP = o.q_size.shape[0] - 1, o.q_fields.shape[1]
    MAXW, WW = o.bitmap.shape[1], o.trim_ring.shape[2] - 2
    EQ, D = o.enq_ids.shape[0], o.in_tbl.shape[1]
    dev = o.dst.device
    wire = o.infl[s.wire]                             # [NE, 7], a view

    # ---- enqueue side: each real slot of a switch row reads its
    # emitter's wire row, then zeroes it
    real = o.in_tbl < EQ                              # [NSW, D]
    e = o.enq_ids[o.in_tbl.clamp_max(EQ - 1)]
    rows = torch.where(real[..., None], wire[e], 0)   # [NSW, D, 7]
    wire[e[real]] = 0
    g = torch.where((rows[..., 0] == 1) & (rows[..., 1] >= 0), rows[..., 1], NQ)
    # rank: same-destination slots below in the row; last: none above
    same = g[:, :, None] == g[:, None, :]
    jd = torch.arange(D, device=dev)
    rank = _isum(same & (jd[None, :] < jd[:, None]), dim=2)
    last = ~torch.any(same & (jd[None, :] > jd[:, None]), dim=2)
    size, head = o.q_size[g], o.q_head[g]             # read before any write
    live = g < NQ
    acc = live & (rank < CAP - size)
    rej = live & ~acc
    pos = torch.remainder(head + size + rank, CAP)
    o.q_fields[g[acc], pos[acc]] = rows[acc][:, 2:7]
    # each queue's size, written by its row's last slot for it
    fin = live & last
    count = torch.minimum(rank + 1, (CAP - size).clamp_min(0))
    o.q_size[g[fin]] = (size + count)[fin]
    flow, seq = rows[..., 2][rej], rows[..., 3][rej]
    psz = (o.size[flow.clamp(0, NF - 1)] - seq * fl.mtu).clamp(0, fl.mtu)
    if fl.trimming:
        ledger = o.trim_ring[s.trim].view(-1)         # [(NF+1) * (2+WW)]
        base = flow * (2 + WW)
        m = torch.remainder(seq, 32 * WW)
        ledger.index_add_(0, base, torch.ones_like(flow))
        ledger.index_add_(0, base + 1, psz)
        ledger.index_add_(0, base + 2 + torch.div(m, 32, rounding_mode="floor"),
                          torch.ones_like(m) << torch.remainder(m, 32))
    (o.n_trim if fl.trimming else o.n_drop).add_(_isum(rej))
    if fl.credit_based:
        staged = torch.zeros((NF + 1,), dtype=I32, device=dev).index_add_(0, flow, psz)
        hit = staged != 0
        o.trim_seen[hit] += staged[hit].to(F32)

    # ---- delivery side: node i reads row QE + i, then zeroes it
    node = torch.arange(N, dtype=I32, device=dev)
    r = wire[fl.qe:fl.qe + N].clone()
    wire[fl.qe:fl.qe + N] = 0
    deliver = (r[:, 0] == 1) & (r[:, 1] < 0)
    o.ack_ring[s.ack] = _ack_rows(r, deliver)
    f = r[:, 2]
    own = deliver & (f >= 0) & (f < NF) & (o.dst[f.clamp(0, NF - 1)] == node)
    fo, dseq = f[own], r[own, 3]
    word = torch.div(dseq, 32, rounding_mode="floor")
    bit = torch.remainder(dseq, 32)
    inw = (word >= 0) & (word < MAXW)
    wc = word.clamp(0, MAXW - 1)
    old = torch.where(inw, o.bitmap[fo, wc], 0)
    new = ((old >> bit) & 1) == 0
    put = new & inw
    o.bitmap[fo[put], wc[put]] = (old + (torch.ones_like(bit) << bit))[put]
    dsz = torch.where(new, (o.size[fo] - dseq * fl.mtu).clamp(0, fl.mtu), 0)
    gp = o.goodput[fo] + dsz
    o.goodput[fo] = gp
    done_now = (gp >= o.size[fo]) & ~o.done[fo]
    o.fct[fo[done_now]] = t + fl.ret - o.t_start[fo[done_now]]
    o.done[fo[done_now]] = True
    dbytes = _isum(dsz).to(F32)
    o.delivered_pkts.add_(_isum(deliver))
    o.delivered_bytes.add_(dbytes)
    _recovery_metrics(t, fl, o, dbytes)
