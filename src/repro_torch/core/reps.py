"""REPS — Recycled Entropy Packet Spraying (paper Alg. 4) and the baseline
load balancers it is evaluated against (Sec. 4.1): oblivious per-packet
spraying, per-flow ECMP, and PLB.

The *entropy* is the header field ECMP hashes on (e.g. IPv6 flow label);
switches need nothing beyond standard ECMP.  REPS state per flow is two
small integers — matching the paper's "minimal complexity" claim.

All four balancers share one dispatch on the static ``lb_mode``; integer
``%`` is the reference's floor modulus (``torch.remainder``), and hashes
come back as uint32 held in int64 (``netsim/hashing.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.netsim import hashing

I32 = torch.int32
F32 = torch.float32

# load-balancer ids (static)
LB_REPS = 0
LB_SPRAY = 1
LB_ECMP = 2
LB_PLB = 3

LB_NAMES = {"reps": LB_REPS, "spray": LB_SPRAY, "ecmp": LB_ECMP, "plb": LB_PLB}


class LBState(NamedTuple):
    """Per-flow load-balancing state, tensors [F]."""

    next_entropy: torch.Tensor     # i32 (REPS Alg. 4 l. 2)
    cached_entropy: torch.Tensor   # i32 (REPS Alg. 4 l. 3)
    explore_sent: torch.Tensor     # i32 packets sent in the explore phase
    spray_ctr: torch.Tensor        # i32 oblivious-spray counter
    plb_entropy: torch.Tensor      # i32 current PLB path
    plb_marked: torch.Tensor       # f32 marked ACKs in current round
    plb_total: torch.Tensor        # f32 ACKs in current round
    plb_congested: torch.Tensor    # i32 consecutive congested rounds
    plb_round_end: torch.Tensor    # f32 tick


class LBParams(NamedTuple):
    num_entropies: torch.Tensor    # i32 (Alg. 4: 256)
    bdp_pkts: torch.Tensor         # i32 explore-phase length (first bdp of packets)
    plb_k: torch.Tensor            # i32 congested rounds before repathing
    plb_frac: torch.Tensor         # f32 marked fraction that flags a round congested


def make_lb_params(num_entropies: int = 256, bdp_pkts: int = 32,
                   plb_k: int = 3, plb_frac: float = 0.5, *,
                   device) -> LBParams:
    i = lambda v: torch.tensor(v, dtype=I32, device=device)
    return LBParams(
        num_entropies=i(num_entropies),
        bdp_pkts=i(bdp_pkts),
        plb_k=i(plb_k),
        plb_frac=torch.tensor(plb_frac, dtype=F32, device=device),
    )


def _hash_mod(h, n):
    """``h % n`` of a uint32 hash (int64-held) by the i32 entropy count,
    back to i32 — the reference's ``(h % n.astype(uint32)).astype(i32)``."""
    return torch.remainder(h, n.to(torch.int64)).to(I32)


def init_lb_state(n_flows: int, params: LBParams, seed: int = 0,
                  lead: tuple = ()) -> LBState:
    """Tick-0 LB state; ``lead`` a lane batch's leading shape (the entropy
    count broadcasts against ``lead + (n_flows,)``)."""
    dev = params.num_entropies.device
    shape = tuple(lead) + (n_flows,)
    flow_ids = torch.arange(n_flows, dtype=I32, device=dev)
    rand = _hash_mod(hashing.hash2(flow_ids, seed), params.num_entropies).expand(shape)
    z32 = lambda: torch.zeros(shape, dtype=I32, device=dev)
    zf = lambda: torch.zeros(shape, dtype=F32, device=dev)
    return LBState(
        next_entropy=rand.clone(),   # start exploration at a random offset
        cached_entropy=rand.clone(),
        explore_sent=z32(),
        spray_ctr=z32(),
        plb_entropy=rand.clone(),
        plb_marked=zf(),
        plb_total=zf(),
        plb_congested=z32(),
        plb_round_end=zf(),
    )


def on_send(lb_mode: int, p: LBParams, s: LBState, flow_mask, seq_pkt, flow_ids, now):
    """Entropy for the packet each flow in `flow_mask` emits this tick.
    Returns (state', entropy[F])."""
    n = p.num_entropies
    if lb_mode == LB_REPS:
        # Alg. 4 l. 5-9: explore the first bdp of packets, then recycle.
        explore = flow_mask & (seq_pkt < p.bdp_pkts) & (s.explore_sent < n)
        entropy = torch.where(explore, torch.remainder(s.next_entropy, n),
                              torch.remainder(s.cached_entropy, n))
        s = s._replace(
            next_entropy=s.next_entropy + explore.to(I32),
            explore_sent=s.explore_sent + explore.to(I32),
        )
        return s, entropy
    if lb_mode == LB_SPRAY:
        h = hashing.hash3(flow_ids, s.spray_ctr, 0x5E4A)
        return (s._replace(spray_ctr=s.spray_ctr + flow_mask.to(I32)),
                _hash_mod(h, n))
    if lb_mode == LB_ECMP:
        return s, torch.remainder(flow_ids, n)
    if lb_mode == LB_PLB:
        return s, torch.remainder(s.plb_entropy, n)
    raise ValueError(f"unknown lb mode {lb_mode}")


def on_timeout(lb_mode: int, p: LBParams, s: LBState, timed_out):
    """Timeout-side update (failure recovery): REPS evicts the cached
    entropy of a flow that just fired an RTO and replaces it with a fresh
    one, so the retransmission explores a different equal-cost path
    instead of re-firing forever into a dead link.  Gated behind
    ``SimConfig.evict_on_timeout`` (Dims.evict) — a no-op for the other
    balancers, whose path choice is not cached per flow."""
    if lb_mode == LB_REPS:
        n = p.num_entropies
        cached = torch.where(timed_out, torch.remainder(s.next_entropy, n),
                             s.cached_entropy)
        return s._replace(
            cached_entropy=cached,
            next_entropy=s.next_entropy + timed_out.to(I32),
        )
    return s


def on_ack(lb_mode: int, p: LBParams, s: LBState, has_ack, ecn, ack_entropy,
           flow_ids, now):
    """ACK-side load-balancer update (``now`` is the integer tick, or a
    lane batch's ticks as an i32 ``[L, 1]`` column)."""
    n = p.num_entropies
    if lb_mode == LB_REPS:
        # Alg. 4 l. 12-17: marked ACK -> fresh entropy; clean ACK -> recycle.
        marked = has_ack & ecn
        clean = has_ack & ~ecn
        cached = torch.where(marked, torch.remainder(s.next_entropy, n),
                             torch.where(clean, ack_entropy, s.cached_entropy))
        return s._replace(
            cached_entropy=cached,
            next_entropy=s.next_entropy + marked.to(I32),
        )
    if lb_mode == LB_PLB:
        # PLB [48]: after plb_k consecutive congested rounds (>= plb_frac of
        # ACKs marked within a round), pick a new random path.
        # exact: ticks stay below 2**24
        now_f = now.to(F32) if isinstance(now, torch.Tensor) else float(now)
        marked = s.plb_marked + (has_ack & ecn).to(F32)
        total = s.plb_total + has_ack.to(F32)
        boundary = now_f >= s.plb_round_end
        congested_round = boundary & (marked >= p.plb_frac * total.clamp_min(1.0)) \
            & (total > 0)
        clean_round = boundary & ~congested_round
        congested = torch.where(congested_round, s.plb_congested + 1,
                                torch.where(clean_round, 0, s.plb_congested))
        repath = congested >= p.plb_k
        new_entropy = _hash_mod(hashing.hash3(flow_ids, now, 0x9187),
                                p.num_entropies)
        return s._replace(
            plb_marked=torch.where(boundary, 0.0, marked),
            plb_total=torch.where(boundary, 0.0, total),
            plb_round_end=torch.where(boundary, now_f + 32.0, s.plb_round_end),
            plb_congested=torch.where(repath, 0, congested),
            plb_entropy=torch.where(repath, new_entropy, s.plb_entropy),
        )
    return s  # spray/ecmp: stateless on ACK
