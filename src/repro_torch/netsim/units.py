"""Unit system for the slotted packet simulator.

One **tick** = serialization time of one MTU at line rate.  All links share a
single rate (as in the paper's setup), so every port forwards exactly one
data packet per tick; control packets (ACKs / trimmed headers / credits) are
~64 B and ride priority queues, i.e. effectively zero serialization time.

Handy invariant: BDP measured in packets == base RTT measured in ticks.
"""

from __future__ import annotations

import dataclasses
import math

HDR_BYTES = 64.0  # trimmed-header / ACK wire size (bytes)


@dataclasses.dataclass(frozen=True)
class LinkConfig:
    """Physical constants. Defaults follow the paper (Sec. 4): 4 KiB MTU,
    600 ns links, 400 ns switch traversal.  100 Gb/s is the paper's reference
    bandwidth for parameter tuning (Sec. 3.5); the headline simulations use
    800 Gb/s, which simply rescales the tick."""

    rate_gbps: float = 100.0
    mtu_bytes: int = 4096
    link_latency_ns: float = 600.0
    switch_latency_ns: float = 400.0

    @property
    def tick_ns(self) -> float:
        return self.mtu_bytes * 8.0 / self.rate_gbps  # ns per MTU

    @property
    def link_lat_ticks(self) -> int:
        return max(1, round(self.link_latency_ns / self.tick_ns))

    @property
    def switch_lat_ticks(self) -> int:
        return max(1, round(self.switch_latency_ns / self.tick_ns))

    @property
    def hop_ticks(self) -> int:
        """Store-and-forward hop: 1 tick serialization + link + switch."""
        return 1 + self.link_lat_ticks + self.switch_lat_ticks


@dataclasses.dataclass(frozen=True)
class FatTreeConfig:
    """Fat tree, two- or three-tier.

    Two-tier (``pods == 0``, the default): ``racks`` T0 switches x
    ``nodes_per_rack`` hosts, each T0 wired with one uplink to each of
    ``uplinks`` spines (T1).  T0 oversubscription = nodes_per_rack /
    uplinks.

    Three-tier (``pods > 0``): the racks are grouped into ``pods`` pods of
    ``racks // pods`` racks.  Each pod has ``uplinks`` T1 aggregation
    switches (every rack wires one uplink to each), and each T1 switch has
    ``core_uplinks`` uplinks into the T2 core.  Core plane: ``uplinks *
    core_uplinks`` T2 switches, where core ``(a, j)`` connects to T1
    switch ``a`` of *every* pod — the standard fat-tree wiring, giving
    ``uplinks * core_uplinks`` equal-cost core paths between pods.
    Per-tier oversubscription: T0 = nodes_per_rack / uplinks, T1 =
    racks_per_pod / core_uplinks."""

    racks: int = 8
    nodes_per_rack: int = 16
    uplinks: int = 4     # T0 uplinks per rack (== spines when two-tier,
                         # == T1 aggs per pod when three-tier)
    pods: int = 0        # 0 = two-tier; > 0 = three-tier pod count
    core_uplinks: int = 0  # T1 -> T2 uplinks per agg (three-tier only)

    def __post_init__(self):
        if self.pods < 0 or self.core_uplinks < 0:
            raise ValueError("pods / core_uplinks must be >= 0")
        if self.pods == 0 and self.core_uplinks:
            raise ValueError(
                "core_uplinks requires a three-tier tree (set pods > 0)")
        if self.pods:
            if self.core_uplinks < 1:
                raise ValueError(
                    "a three-tier tree (pods > 0) needs core_uplinks >= 1")
            if self.racks % self.pods:
                raise ValueError(
                    f"racks ({self.racks}) must divide evenly into pods "
                    f"({self.pods})")

    @property
    def tiers(self) -> int:
        return 3 if self.pods else 2

    @property
    def n_nodes(self) -> int:
        return self.racks * self.nodes_per_rack

    @property
    def racks_per_pod(self) -> int:
        """Racks under one T1 subtree (the whole fabric when two-tier)."""
        return self.racks // self.pods if self.pods else self.racks

    @property
    def n_t1(self) -> int:
        """T1 switches: spines (two-tier) or aggs over all pods."""
        return self.pods * self.uplinks if self.pods else self.uplinks

    @property
    def n_cores(self) -> int:
        return self.uplinks * self.core_uplinks if self.pods else 0

    @property
    def n_spines(self) -> int:
        return self.uplinks

    @property
    def n_switches(self) -> int:
        return self.racks + self.n_t1 + self.n_cores

    @property
    def oversubscription(self) -> float:
        return self.nodes_per_rack / self.uplinks

    @property
    def core_oversubscription(self) -> float:
        """T1-tier oversubscription (1.0 for two-tier trees)."""
        if not self.pods:
            return 1.0
        return self.racks_per_pod / self.core_uplinks


@dataclasses.dataclass(frozen=True)
class Timing:
    """Derived tick-domain latencies.  ``*_inter`` is the longest path in
    the fabric (cross-core when three-tier, cross-rack when two-tier) —
    ring/buffer sizing and the reference BDP key off it.  ``*_pod`` is the
    cross-rack-within-a-pod path (== ``*_inter`` on two-tier trees)."""

    hop: int            # per store-and-forward hop (data path)
    ret_inter: int      # priority-path return latency, longest path
    ret_pod: int        # priority-path return latency, intra-pod cross-rack
    ret_intra: int      # priority-path return latency, same rack
    fwd_inter: int      # empty-network one-way data latency, longest path
    fwd_pod: int
    fwd_intra: int
    brtt_inter: int     # base RTT (ticks == BDP in packets)
    brtt_pod: int
    brtt_intra: int
    trim_delay: int     # trim event -> sender notification latency


def path_queues(tree: FatTreeConfig | None) -> tuple[int, int, int]:
    """Queues traversed per path class (intra-rack, intra-pod cross-rack,
    longest): the hop counts the timing model is parameterized by."""
    h_inter = 5 if (tree is not None and tree.tiers == 3) else 3
    return 1, 3, h_inter


def derive_timing(link: LinkConfig, tree: FatTreeConfig | None = None) -> Timing:
    l, s = link.link_lat_ticks, link.switch_lat_ticks
    hop = link.hop_ticks
    # A data path through h queues: NIC emission (+1+l+s, landing in the
    # first queue), h-1 store-and-forward switch hops (+1+l+s each), and the
    # final host link off the t0_down port (+1+l, no switch at the host).
    # h = 1 intra-rack (t0_down only), 3 cross-rack via T1 (t0_up, t1_down,
    # t0_down), 5 cross-pod via the core (t0_up, t1_up, t2_down, t1_down,
    # t0_down).  Control returns ride priority queues: no serialization.
    h_intra, h_pod, h_inter = path_queues(tree)

    def fwd(h):
        return (1 + l + s) * h + (1 + l)

    def ret(h):
        return (l + s) * h + l

    # trimmed header: forwarded (priority) from mid-path to receiver, then
    # NACK back -- approximately one priority-path RTT from the trim point.
    trim_delay = ret(h_inter) + (1 + l + s)
    return Timing(
        hop=hop,
        ret_inter=ret(h_inter),
        ret_pod=ret(h_pod),
        ret_intra=ret(h_intra),
        fwd_inter=fwd(h_inter),
        fwd_pod=fwd(h_pod),
        fwd_intra=fwd(h_intra),
        brtt_inter=fwd(h_inter) + ret(h_inter),
        brtt_pod=fwd(h_pod) + ret(h_pod),
        brtt_intra=fwd(h_intra) + ret(h_intra),
        trim_delay=trim_delay,
    )


def bdp_bytes(link: LinkConfig, timing: Timing) -> float:
    return float(timing.brtt_inter * link.mtu_bytes)


def reference_bdp_bytes() -> float:
    """Paper Sec. 3.5: reference bdp = 100 Gb/s network with 12 us RTT."""
    return 100e9 / 8.0 * 12e-6  # = 150_000 bytes


def gamma(link: LinkConfig, timing: Timing) -> float:
    """fi/mi bandwidth-latency scaling factor (paper Sec. 3.5)."""
    return bdp_bytes(link, timing) / reference_bdp_bytes()


def ns_to_ticks(ns: float, link: LinkConfig) -> int:
    return int(math.ceil(ns / link.tick_ns))


def ticks_to_us(ticks, link: LinkConfig) -> float:
    return ticks * link.tick_ns * 1e-3
