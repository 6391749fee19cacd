"""Plain PyTorch versions of the fused sends phase (``csrc/sends.cu``).

``sends_ref`` is ``sender.sends`` for one tick on flat operands, with the
fused kernel's exact contract:

  1. admission of every flow (``admission``): activation (start tick,
     unfinished, the dependency table's parents past their thresholds),
     the windowed count of unfinished predecessors, the first pending
     retransmission of the sent ring or else the next new sequence, the
     window, credit and (with the pacing budget accrued first) pacing
     gates;
  2. one packet a sender: the round-robin pick over the sender's row of
     ``flows_of`` (``arb``, ``rr_pick``'s contract; the identity where a
     row holds one flow) and the cursor ``rr_send`` past it;
  3. the emitting flow's entropy by the load balancer and its first hop
     (``fabric.route_first_hop``), its packet on the sender's NIC row of
     the wire slot (zeros for an idle NIC), its sent-ring slot, its next
     sequence, the load balancer's counters, credits or speculative budget
     and pacing budget, and the retransmission count.

It updates in place: the NIC rows of the wire slot, the sent ring,
``next_seq``, ``rr_send``, ``pace_accum``, ``credits``/``spec_budget``,
the LB counters (``next_entropy``, ``explore_sent``, ``spray_ctr``) and
``n_retx`` (a state passed to a phase is consumed).  Operation for
operation the reference's ``sender.sends`` (``repro/netsim/sender.py:132``).
``sends_lanes_ref`` is the same phase on a lane batch (``kernels/lanes``:
every operand ``[L, ...]``), the kernel's contract: ``sends_ref`` on each
live lane at its own tick and wire slot, the other lanes left as they
were.  ``activated`` and ``admission`` take a lane batch too (the run
loop's leap horizon and the EQDS grants read them for every lane at
once): a state ``[L, ...]`` with the run's constants as they are (shared)
or ``[L, 1]``-shaped (swept), and the tick as an i32 ``[L, 1]`` column.

``sends_by_sender`` computes the same function in the kernel's own
formulation: each sender's row of ``flows_of`` taken 32 slots at a time
(a warp's lanes), the windowed count carried across those chunks, the
retransmission scan of a started flow 32 ring words at a time (first
pending slot wins), the running best ``(key, slot)`` of the row, and the
emission by the winner alone.  Both rely on the simulator's invariants:
``flows_of[src[f], slot_of[f]] == f`` for every flow (each flow sits in
one sender's row, its padding is ``NF``), and sequence numbers are never
negative.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core import reps
from repro_torch.kernels import lanes
from repro_torch.kernels.enqueue_arb import ops as enqueue_arb_ops
from repro_torch.netsim import fabric, hashing

I32 = torch.int32
F32 = torch.float32
# the LB counters the phase adds to (the others it only reads)
LB_COUNTERS = ("next_entropy", "explore_sent", "spray_ctr")


class Flags(NamedTuple):
    """The run's constants that shape the phase (from ``Dims``).  The
    row width ``FMAX``, the dependency-table width ``D`` and the ring
    width ``W`` are the operands' shapes."""

    window: int           # eligibility window: the gate runs where window < FMAX
    credit_based: bool    # EQDS credits or speculative budget gate and pay
    paced: bool           # the pacing budget accrues, gates and pays
    lb_mode: int          # core.reps LB_REPS / LB_SPRAY / LB_ECMP / LB_PLB
    mtu: int              # bytes


class Operands(NamedTuple):
    """The phase's tensors.  ``NF`` flows, ``N`` senders of up to ``FMAX``
    flows, ``D`` dependency columns, sent ring ``W`` slots, wire ring
    ``L`` slots of ``NE = NQ + N`` rows (the senders' NICs last)."""

    src: torch.Tensor          # i32 [NF] sending node
    t_start: torch.Tensor      # i32 [NF]
    size: torch.Tensor         # i32 [NF] flow bytes
    dep_par: torch.Tensor      # i32 [NF, D] parent flow id (NF = free)
    dep_thr: torch.Tensor      # i32 [NF, D] parent bytes before activation
    flows_of: torch.Tensor     # i32 [N, FMAX] each sender's flows, padded with NF
    slot_of: torch.Tensor      # i32 [NF] flow's column in flows_of[src]
    flow_ids: torch.Tensor     # i32 [NF] iota (the plain version's tables)
    node_ids: torch.Tensor     # i32 [N] iota
    f_down: torch.Tensor       # bool [NF] destination in the sender's rack
    f_dn_q: torch.Tensor       # i32 [NF] the same-rack edge queue
    f_up_base: torch.Tensor    # i32 [NF] rack switch's first up port
    f_up_cnt: torch.Tensor     # i32 [NF] rack switch's up-port count
    f_salt: torch.Tensor       # i64 [NF] rack switch's ECMP salt (a uint32)
    num_entropies: torch.Tensor  # i32 scalar
    bdp_pkts: torch.Tensor     # i32 scalar REPS explore-phase length
    done: torch.Tensor         # bool [NF] (read)
    goodput: torch.Tensor      # i32 [NF] (read: the dependency gate)
    unacked: torch.Tensor      # f32 [NF] (read)
    cwnd: torch.Tensor         # f32 [NF] (read)
    pacing_rate: torch.Tensor  # f32 [NF] (read where paced)
    credits: torch.Tensor      # f32 [NF]; paid from where credit_based
    spec_budget: torch.Tensor  # f32 [NF]; paid from where credit_based
    pace_accum: torch.Tensor   # f32 [NF]; accrued and paid where paced
    sent: torch.Tensor         # i32 [3, NF+1, W] state/seq/send tick
    next_seq: torch.Tensor     # i32 [NF]
    rr_send: torch.Tensor      # i32 [N] round-robin cursors
    next_entropy: torch.Tensor   # i32 [NF] LB state (REPS adds to it)
    cached_entropy: torch.Tensor  # i32 [NF] (read)
    explore_sent: torch.Tensor   # i32 [NF] (REPS adds to it)
    spray_ctr: torch.Tensor      # i32 [NF] (spray adds to it)
    plb_entropy: torch.Tensor    # i32 [NF] (read)
    infl: torch.Tensor         # i32 [L, NE, 7]; rows [NQ, NE) of slot `wire` written
    n_retx: torch.Tensor       # i32 scalar counter, added to


def _isum(x):
    return torch.sum(x, dtype=I32)


def activated(t, t_start, done, goodput, dep_par, dep_thr):
    """The activation predicate (DESIGN.md Sec. 11): a flow is live once
    ``t >= t_start``, it is unfinished, and — when the workload carries a
    dependency table — every parent has delivered its threshold bytes."""
    act = (t >= t_start) & ~done
    if dep_par.shape[-1]:
        # goodput of each parent (pad row NF covers the free-slot sentinel)
        gp = torch.cat([goodput, goodput.new_zeros(goodput.shape[:-1] + (1,))],
                       dim=-1)[..., dep_par]
        ok = (dep_par == done.shape[-1]) | (gp >= dep_thr)
        act = act & torch.all(ok, dim=-1)
    return act


def admission(t, fl: Flags, o: Operands):
    """Send admission of every flow at tick ``t``, *excluding* rate pacing
    (``sends_ref`` folds in the freshly accrued pacing budget).  Returns
    ``(elig, has_retx, seq_emit, nsize)``."""
    NF, FMAX, W = o.src.shape[-1], o.flows_of.shape[-1], o.sent.shape[-1]
    mtu = fl.mtu
    started = activated(t, o.t_start, o.done, o.goodput, o.dep_par, o.dep_thr)
    if fl.window < FMAX:
        # windowed-alltoall eligibility: < window unfinished predecessors,
        # gathered from the per-sender prefix count
        done_p = torch.cat([o.done, o.done.new_ones(o.done.shape[:-1] + (1,))], dim=-1)
        unfin = ~done_p[..., o.flows_of] & (o.flows_of < NF)  # [.., N, FMAX]
        prior_unfin = torch.cumsum(unfin, dim=-1, dtype=I32) - unfin.to(I32)
        started = started & (prior_unfin[..., o.src, o.slot_of] < fl.window)

    ring = o.sent[..., 0, :NF, :]
    is_retx = ring == 3
    has_retx = torch.any(is_retx, dim=-1)
    retx_slot = torch.argmax(is_retx.to(I32), dim=-1)    # first index on ties
    retx_seq = torch.gather(o.sent[..., 1, :NF, :], -1, retx_slot[..., None])[..., 0]
    new_seq = o.next_seq
    new_slot = torch.remainder(new_seq, W)
    new_ok = (new_seq * mtu < o.size) & \
        (torch.gather(ring, -1, new_slot.long()[..., None])[..., 0] == 0)
    seq_emit = torch.where(has_retx, retx_seq, new_seq)
    nsize = (o.size - seq_emit * mtu).clamp(0, mtu).to(F32)
    win_ok = o.unacked + nsize <= o.cwnd
    elig = started & (has_retx | new_ok) & win_ok & (nsize > 0)
    if fl.credit_based:
        elig = elig & ((o.credits >= nsize) | (o.spec_budget >= nsize))
    return elig, has_retx, seq_emit, nsize


def _lb(o: Operands):
    """The operands' LB parameters and state as ``core.reps`` takes them
    (the PLB round fields, which sending never reads, left out)."""
    p = reps.LBParams(num_entropies=o.num_entropies, bdp_pkts=o.bdp_pkts,
                      plb_k=None, plb_frac=None)
    s = reps.LBState(next_entropy=o.next_entropy, cached_entropy=o.cached_entropy,
                     explore_sent=o.explore_sent, spray_ctr=o.spray_ctr,
                     plb_entropy=o.plb_entropy, plb_marked=None, plb_total=None,
                     plb_congested=None, plb_round_end=None)
    return p, s


def sends_ref(t: int, wire: int, fl: Flags, o: Operands, *, arb=None) -> None:
    """One tick of the sends phase; updates ``o`` in place (module
    docstring).  ``wire`` is the wire slot the NICs emit into,
    ``(t + lat_send) % L``.  ``arb`` is the round-robin pick
    (``enqueue_arb/ops.rr_pick``'s signature); its plain version by
    default, the ``rr_pick`` kernel under the split design
    (``ops.get("split")``)."""
    if arb is None:
        arb = functools.partial(enqueue_arb_ops.rr_pick, backend="plain")
    NF, (N, FMAX) = o.src.shape[0], o.flows_of.shape
    NQ, W = o.infl.shape[1] - N, o.sent.shape[2]
    flow_ids = o.flow_ids
    dev = o.src.device

    pace = o.pace_accum
    if fl.paced:
        pace = torch.clamp_max(pace + o.pacing_rate, 4.0 * float(fl.mtu))

    elig, has_retx, seq_emit, nsize = admission(t, fl, o)
    if fl.paced:
        elig = elig & (pace >= nsize)

    # per-sender round-robin arbitration (one packet per NIC per tick)
    elig_p = torch.cat([elig, elig.new_zeros(1)])
    if FMAX == 1:
        # at most one flow per sender: arbitration is the identity
        has_s = elig_p[o.flows_of[:, 0]]
        sflow = torch.where(has_s, o.flows_of[:, 0], NF)
    else:
        E = elig_p[o.flows_of]                                  # [N, FMAX]
        has_s, sel = arb(E, o.rr_send, FMAX)
        sflow = torch.where(has_s, o.flows_of[o.node_ids, sel], NF)
        o.rr_send.copy_(torch.where(has_s, torch.remainder(sel + 1, FMAX), o.rr_send))

    # flow f emits iff its own sender selected it (gather, not scatter)
    emit_mask = sflow[o.src] == flow_ids
    p, s = _lb(o)
    lb, entropy = reps.on_send(fl.lb_mode, p, s, emit_mask, seq_emit, flow_ids, t)
    for name in LB_COUNTERS:
        if getattr(lb, name) is not getattr(s, name):
            getattr(o, name).copy_(getattr(lb, name))
    # the operands carry the first-hop tables under Consts' names
    first_q = fabric.route_first_hop(None, o, entropy)

    # place on the wire: the NIC emitter rows [NQ, NE) of the (uniform)
    # sender-latency slot, zeros for idle NICs
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
    o.infl[wire, NQ:] = spay

    # sent-ring bookkeeping: one-hot masked write of the [3, NF, W] body
    # (the emitting flow's slot is seq_emit % W); the write-off row NF is
    # never touched
    hit = emit_mask[:, None] & \
        (torch.arange(W, dtype=I32, device=dev)[None, :]
         == torch.remainder(seq_emit, W)[:, None])
    body = o.sent[:, :NF]
    o.sent[:, :NF] = torch.stack([
        torch.where(hit, 1, body[0]),
        torch.where(hit, seq_emit[:, None], body[1]),
        torch.where(hit, t, body[2]),
    ])
    is_new_send = emit_mask & ~has_retx
    o.next_seq.add_(is_new_send.to(I32))
    o.n_retx.add_(_isum(emit_mask & has_retx))

    spend = torch.where(emit_mask, nsize, 0.0)
    if fl.credit_based:
        use_credit = o.credits >= nsize
        credits = o.credits - spend * use_credit
        spec_budget = o.spec_budget - spend * ~use_credit
        o.credits.copy_(credits)
        o.spec_budget.copy_(spec_budget)
    if fl.paced:
        o.pace_accum.copy_(pace - spend)


def sends_lanes_ref(k: lanes.Tick, lat_send: int, fl: Flags, o: Operands, *,
                    arb=None) -> None:
    """The phase on a lane batch, in place: :func:`sends_ref` on each live
    lane at its own tick (``k.now_h``) and wire slot ``(t + lat_send) % L``."""
    l = o.infl.shape[-3]
    views = lanes.lane_views(lanes.thread_cache(__name__), o, k.n)
    for i, (t, go) in enumerate(zip(k.now_h, k.live_h)):
        if go:
            sends_ref(t, (t + lat_send) % l, fl, views[i], arb=arb)


def sends_by_sender(t: int, wire: int, fl: Flags, o: Operands) -> None:
    """``sends_ref``'s function in the fused kernel's formulation (module
    docstring): a sender's row 32 slots at a time, the winner emits."""
    NF, (N, FMAX) = o.src.shape[0], o.flows_of.shape
    NQ, W = o.infl.shape[1] - N, o.sent.shape[2]
    mtu = fl.mtu
    dev = o.src.device
    zi = lambda: torch.zeros((N,), dtype=I32, device=dev)   # noqa: E731
    carry = zi()                                 # unfinished flows in earlier chunks
    best_key = torch.full((N,), FMAX + 1, dtype=I32, device=dev)
    best_col, best_f, best_seq = zi(), zi(), zi()
    best_retx = torch.zeros((N,), dtype=torch.bool, device=dev)
    best_nsize = torch.zeros((N,), dtype=F32, device=dev)
    rows = torch.arange(N, device=dev)
    for c0 in range(0, FMAX, 32):
        f = o.flows_of[:, c0:c0 + 32]                           # [N, k]
        cols = torch.arange(c0, c0 + f.shape[1], dtype=I32, device=dev)
        real = f < NF
        fc = f.clamp_max(NF - 1)
        done = o.done[fc]
        started = real & (t >= o.t_start[fc]) & ~done
        if o.dep_par.shape[1]:
            par = o.dep_par[fc]                                 # [N, k, D]
            gp = o.goodput[par.clamp_max(NF - 1)]
            started &= torch.all((par == NF) | (gp >= o.dep_thr[fc]), dim=2)
        if fl.window < FMAX:
            unfin = (real & ~done).to(I32)
            prior = carry[:, None] + torch.cumsum(unfin, dim=1, dtype=I32) - unfin
            carry = carry + torch.sum(unfin, dim=1, dtype=I32)
            started &= prior < fl.window
        # the first pending retransmission of a started flow, 32 words a step
        has_retx = torch.zeros_like(started)
        rslot = torch.zeros_like(f)
        ring = o.sent[0][fc]                                    # [N, k, W]
        for b0 in range(0, W, 32):
            blk = (ring[:, :, b0:b0 + 32] == 3) & started[..., None]
            anyb = torch.any(blk, dim=2)
            first = torch.argmax(blk.to(I32), dim=2).to(I32) + b0
            rslot = torch.where(~has_retx & anyb, first, rslot)
            has_retx = has_retx | anyb
        new_seq = o.next_seq[fc]
        new_ok = (new_seq * mtu < o.size[fc]) & \
            (o.sent[0][fc, torch.remainder(new_seq, W)] == 0)
        seq = torch.where(has_retx, o.sent[1][fc, rslot], new_seq)
        nsize = (o.size[fc] - seq * mtu).clamp(0, mtu).to(F32)
        elig = started & (has_retx | new_ok) & (o.unacked[fc] + nsize <= o.cwnd[fc]) & \
            (nsize > 0)
        if fl.credit_based:
            elig &= (o.credits[fc] >= nsize) | (o.spec_budget[fc] >= nsize)
        if fl.paced:
            pace = torch.clamp_max(o.pace_accum[fc] + o.pacing_rate[fc], 4.0 * float(mtu))
            elig &= pace >= nsize
            o.pace_accum[f[real]] = pace[real]                  # every flow of the row
        key = torch.where(elig, torch.remainder(cols[None, :] - o.rr_send[:, None], FMAX),
                          FMAX + 1)
        ci = torch.argmin(key, dim=1)                           # first index on ties
        ck = key[rows, ci]
        better = ck < best_key            # an earlier chunk keeps a tie
        best_key = torch.where(better, ck, best_key)
        best_col = torch.where(better, (ci + c0).to(I32), best_col)
        best_f = torch.where(better, f[rows, ci], best_f)
        best_seq = torch.where(better, seq[rows, ci], best_seq)
        best_retx = torch.where(better, has_retx[rows, ci], best_retx)
        best_nsize = torch.where(better, nsize[rows, ci], best_nsize)
    has_s = best_key <= FMAX
    if FMAX > 1:
        o.rr_send.copy_(torch.where(has_s, torch.remainder(best_col + 1, FMAX), o.rr_send))

    # the winners emit
    e = rows[has_s]
    fw, seq, retx, nsize = best_f[has_s], best_seq[has_s], best_retx[has_s], best_nsize[has_s]
    n = o.num_entropies
    if fl.lb_mode == reps.LB_REPS:
        explore = (seq < o.bdp_pkts) & (o.explore_sent[fw] < n)
        ent = torch.where(explore, torch.remainder(o.next_entropy[fw], n),
                          torch.remainder(o.cached_entropy[fw], n))
        o.next_entropy[fw] += explore.to(I32)
        o.explore_sent[fw] += explore.to(I32)
    elif fl.lb_mode == reps.LB_SPRAY:
        h = hashing.hash3(fw, o.spray_ctr[fw], 0x5E4A)
        ent = torch.remainder(h, n.to(torch.int64)).to(I32)
        o.spray_ctr[fw] += 1
    elif fl.lb_mode == reps.LB_ECMP:
        ent = torch.remainder(fw, n)
    elif fl.lb_mode == reps.LB_PLB:
        ent = torch.remainder(o.plb_entropy[fw], n)
    else:
        raise ValueError(f"unknown lb mode {fl.lb_mode}")
    h = hashing.hash2(ent, o.f_salt[fw])
    up = torch.remainder(h, o.f_up_cnt[fw].clamp_min(1).to(torch.int64)).to(I32)
    q = torch.where(o.f_down[fw], o.f_dn_q[fw], o.f_up_base[fw] + up)
    nic = o.infl[wire, NQ:]
    nic.zero_()
    nic[e] = torch.stack([torch.ones_like(fw), q, fw, seq, ent, torch.zeros_like(fw),
                          torch.full_like(fw, t)], dim=1)
    slot = torch.remainder(seq, W)
    o.sent[0, fw, slot] = 1
    o.sent[1, fw, slot] = seq
    o.sent[2, fw, slot] = t
    o.next_seq[fw] += (~retx).to(I32)
    o.n_retx.add_(_isum(retx))
    if fl.credit_based:
        use = o.credits[fw] >= nsize
        o.credits[fw[use]] -= nsize[use]
        o.spec_budget[fw[~use]] -= nsize[~use]
    if fl.paced:
        o.pace_accum[fw] -= nsize

