"""REPS — Recycled Entropy Packet Spraying (paper Alg. 4) and the baseline
load balancers it is evaluated against (Sec. 4.1): oblivious per-packet
spraying, per-flow ECMP, and PLB.

The *entropy* is the header field ECMP hashes on (e.g. IPv6 flow label);
switches need nothing beyond standard ECMP.  REPS state per flow is two
small integers — matching the paper's "minimal complexity" claim.
"""

from __future__ import annotations

from typing import NamedTuple

from . import np32 as jnp

from . import hashing

# load-balancer ids (static at trace time)
LB_REPS = 0
LB_SPRAY = 1
LB_ECMP = 2
LB_PLB = 3

LB_NAMES = {"reps": LB_REPS, "spray": LB_SPRAY, "ecmp": LB_ECMP, "plb": LB_PLB}


class LBState(NamedTuple):
    """Per-flow load-balancing state, arrays [F]."""

    next_entropy: jnp.ndarray     # i32 (REPS Alg. 4 l. 2)
    cached_entropy: jnp.ndarray   # i32 (REPS Alg. 4 l. 3)
    explore_sent: jnp.ndarray     # i32 packets sent in the explore phase
    spray_ctr: jnp.ndarray        # i32 oblivious-spray counter
    plb_entropy: jnp.ndarray      # i32 current PLB path
    plb_marked: jnp.ndarray       # f32 marked ACKs in current round
    plb_total: jnp.ndarray        # f32 ACKs in current round
    plb_congested: jnp.ndarray    # i32 consecutive congested rounds
    plb_round_end: jnp.ndarray    # f32 tick


class LBParams(NamedTuple):
    num_entropies: jnp.ndarray    # i32 (Alg. 4: 256)
    bdp_pkts: jnp.ndarray         # i32 explore-phase length (first bdp of packets)
    plb_k: jnp.ndarray            # i32 congested rounds before repathing
    plb_frac: jnp.ndarray         # f32 marked fraction that flags a round congested


def make_lb_params(num_entropies: int = 256, bdp_pkts: int = 32,
                   plb_k: int = 3, plb_frac: float = 0.5) -> LBParams:
    return LBParams(
        num_entropies=jnp.asarray(num_entropies, jnp.int32),
        bdp_pkts=jnp.asarray(bdp_pkts, jnp.int32),
        plb_k=jnp.asarray(plb_k, jnp.int32),
        plb_frac=jnp.asarray(plb_frac, jnp.float32),
    )


def init_lb_state(n_flows: int, params: LBParams, seed: int = 0) -> LBState:
    flow_ids = jnp.arange(n_flows, dtype=jnp.int32)
    rand = (hashing.hash2(flow_ids, jnp.int32(seed)) % params.num_entropies.astype(jnp.uint32)).astype(jnp.int32)
    # Every field gets its own buffer: the engine's run loops donate the
    # whole SimState to XLA, and donating one buffer through two pytree
    # leaves is a runtime error.
    z32 = lambda: jnp.zeros((n_flows,), jnp.int32)
    zf = lambda: jnp.zeros((n_flows,), jnp.float32)
    return LBState(
        next_entropy=rand,           # start exploration at a random offset
        cached_entropy=jnp.copy(rand),
        explore_sent=z32(),
        spray_ctr=z32(),
        plb_entropy=jnp.copy(rand),
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
        entropy = jnp.where(explore, s.next_entropy % n, s.cached_entropy % n)
        s = s._replace(
            next_entropy=s.next_entropy + explore.astype(jnp.int32),
            explore_sent=s.explore_sent + explore.astype(jnp.int32),
        )
        return s, entropy
    if lb_mode == LB_SPRAY:
        h = hashing.hash3(flow_ids, s.spray_ctr, jnp.int32(0x5E4A))
        entropy = (h % n.astype(jnp.uint32)).astype(jnp.int32)
        return s._replace(spray_ctr=s.spray_ctr + flow_mask.astype(jnp.int32)), entropy
    if lb_mode == LB_ECMP:
        return s, flow_ids % n
    if lb_mode == LB_PLB:
        return s, s.plb_entropy % n
    raise ValueError(f"unknown lb mode {lb_mode}")


def on_timeout(lb_mode: int, p: LBParams, s: LBState, timed_out):
    """Timeout-side update (failure recovery): REPS evicts the
    cached entropy of a flow that just fired an RTO and replaces it with
    a fresh one, so the retransmission explores a different equal-cost
    path instead of re-firing forever into a dead link.  Gated behind
    ``SimConfig.evict_on_timeout`` (Dims.evict) — a no-op for the other
    balancers, whose path choice is not cached per flow."""
    if lb_mode == LB_REPS:
        n = p.num_entropies
        cached = jnp.where(timed_out, s.next_entropy % n, s.cached_entropy)
        return s._replace(
            cached_entropy=cached,
            next_entropy=s.next_entropy + timed_out.astype(jnp.int32),
        )
    return s


def on_ack(lb_mode: int, p: LBParams, s: LBState, has_ack, ecn, ack_entropy, flow_ids, now):
    """ACK-side load-balancer update."""
    now = jnp.asarray(now, jnp.float32)
    n = p.num_entropies
    if lb_mode == LB_REPS:
        # Alg. 4 l. 12-17: marked ACK -> fresh entropy; clean ACK -> recycle.
        marked = has_ack & ecn
        clean = has_ack & ~ecn
        cached = jnp.where(marked, s.next_entropy % n,
                           jnp.where(clean, ack_entropy, s.cached_entropy))
        return s._replace(
            cached_entropy=cached,
            next_entropy=s.next_entropy + marked.astype(jnp.int32),
        )
    if lb_mode == LB_PLB:
        # PLB [48]: after plb_k consecutive congested rounds (>= plb_frac of
        # ACKs marked within a round), pick a new random path.
        marked = s.plb_marked + (has_ack & ecn).astype(jnp.float32)
        total = s.plb_total + has_ack.astype(jnp.float32)
        boundary = now >= s.plb_round_end
        congested_round = boundary & (marked >= p.plb_frac * jnp.maximum(total, 1.0)) & (total > 0)
        clean_round = boundary & ~congested_round
        congested = jnp.where(congested_round, s.plb_congested + 1,
                              jnp.where(clean_round, 0, s.plb_congested))
        repath = congested >= p.plb_k
        new_entropy = (hashing.hash3(flow_ids, now.astype(jnp.int32), jnp.int32(0x9187))
                       % p.num_entropies.astype(jnp.uint32)).astype(jnp.int32)
        return s._replace(
            plb_marked=jnp.where(boundary, 0.0, marked),
            plb_total=jnp.where(boundary, 0.0, total),
            plb_round_end=jnp.where(boundary, now + 32.0, s.plb_round_end),
            plb_congested=jnp.where(repath, 0, congested),
            plb_entropy=jnp.where(repath, new_entropy, s.plb_entropy),
        )
    return s  # spray/ecmp: stateless on ACK
