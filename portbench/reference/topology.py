"""Tier-generic fat-tree topology: static port enumeration + routing tables.

Queue (output-port) layout, indexed contiguously; empty blocks vanish, so a
two-tier tree reproduces the historical layout exactly:

  t0_up[r, a]    : rack r's uplink to T1 switch a        (P * U1 ports)
  t1_up[s1, j]   : T1 switch s1's uplink to the core     (3-tier only)
  t2_down[c, g]  : core c's downlink to pod g            (3-tier only)
  t1_down[s1, i] : T1 switch s1's downlink to its i-th rack
  t0_down[node]  : rack's downlink to a host NIC         (last N queues)

Emitters (anything that can place one packet per tick onto a wire):
  ids [0, NQ)            : the queues above
  ids [NQ, NQ + N)       : host NICs (senders)

Every queue below the t0_down block faces a switch; the t0_down block faces
hosts — so wire latency stays uniform within three contiguous emitter
classes (switch-facing, host-facing, sender NICs), which the fabric's
dynamic-update-slice wire writes rely on.

Routing is table-driven and purely functional: each emitter names the
switch its wire feeds (``nbr_sw``), and each switch carries its subtree
interval ``[sw_lo, sw_hi)`` of host nodes, its closed-form down-port rule,
and its contiguous run of equal-cost up ports (``sw_up_base``/
``sw_up_cnt``).  A packet at a switch goes *down* when dst is in the
subtree, else *up* via an ECMP hash of the packet entropy with the
per-switch salt ``sw_salt`` — exactly like switch ECMP hashing a header
field (paper Sec. 3.6); on a three-tier tree the same hash selects among
core paths at the T1 tier.  ``fabric.route_switch`` is the (single) jax
consumer of these tables.

Down-routing is interval/run-length coded rather than a dense
``[NSW, N]`` table: at every tier the down ports of a switch cover its
subtree in runs of equal length (1 node per rack port, ``M`` nodes per T1
port, ``M * racks_per_pod`` nodes per core port), so the down port toward
node ``d`` is ``dn_base[sw] + d // dn_stride[sw]`` — two [NSW] vectors
replace the O(NSW * N) table the fabric used to gather through (the dense
``down_tbl`` is still materialized here, as numpy, for tests and tools).

Exactly the emitters with ``nbr_sw >= 0`` can ever enqueue (t0_down ports
deliver to hosts instead); ``enq_ids`` enumerates them in ascending id
order, and the whole enqueue path — ranking, queue writes, trim ledger —
runs on that compacted [EQ] axis rather than all ``n_emitters`` rows.
``in_tbl``/``in_pos`` give the inverse of ``nbr_sw`` over the compact
enumeration: ``in_tbl[sw]`` lists the compact indices of the emitters
feeding switch ``sw`` in ascending id order (padded with ``len(enq_ids)``),
and ``in_pos[j]`` is compact emitter ``j``'s flat slot in that table.
Emitters enqueueing to the same destination queue always feed the same
switch (a queue belongs to exactly one switch — ``sw_of_q``), so the
fabric's same-destination enqueue ranking only needs pairwise compares
*within* a switch's fan-in group — O(NSW * fan_max^2) instead of O(NE^2) —
and the per-queue accepted counts reduce over the owner's group instead of
a segment-sum scatter.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .units import FatTreeConfig

KIND_T0_UP = 0
KIND_T1_DOWN = 1
KIND_T0_DOWN = 2
KIND_SENDER = 3
KIND_T1_UP = 4
KIND_T2_DOWN = 5

HOST = -1  # nbr_sw sentinel: this port's wire ends at a host NIC

# the historical per-rack ECMP salt formula, now applied per switch id
# (rack switch ids equal rack indices, so two-tier hashes are unchanged)
SALT_MUL = 0x9E37
SALT_ADD = 0x1234


@dataclasses.dataclass(frozen=True)
class Topology:
    tree: FatTreeConfig
    n_queues: int
    n_emitters: int
    n_switches: int
    # per-emitter static arrays (numpy; moved to device by the engine)
    kind: np.ndarray        # [E] emitter kind
    rack: np.ndarray        # [E] rack (T0) / T1 index / core index
    aux: np.ndarray         # [E] uplink / local-rack / node auxiliary index
    nbr_sw: np.ndarray      # [E] switch this emitter's wire feeds (HOST = -1)
    # per-switch routing tables (switch ids: racks [0, P), T1 [P, P+n_t1),
    # cores [P+n_t1, P+n_t1+n_cores))
    sw_tier: np.ndarray     # [NSW] 0 = rack, 1 = T1, 2 = core
    sw_lo: np.ndarray       # [NSW] subtree host interval [lo, hi)
    sw_hi: np.ndarray
    sw_up_base: np.ndarray  # [NSW] first up-port queue id
    sw_up_cnt: np.ndarray   # [NSW] equal-cost up ports (0 at the top tier)
    sw_salt: np.ndarray     # [NSW] uint32 per-switch ECMP hash salt
    down_tbl: np.ndarray    # [NSW, N] down-port queue id toward each node
    #   (dense reference form; the fabric routes via dn_base/dn_stride)
    dn_base: np.ndarray     # [NSW] down port = dn_base + dst // dn_stride
    dn_stride: np.ndarray   # [NSW] nodes covered per down port
    sw_of_q: np.ndarray     # [NQ] switch owning each queue (output port)
    # compact enqueue-capable emitter enumeration + per-switch fan-in
    # (inverse of nbr_sw over that enumeration; enqueue-rank groups)
    enq_ids: np.ndarray     # [EQ] emitter ids with nbr_sw >= 0, ascending
    fan_max: int            # max emitters feeding one switch
    in_tbl: np.ndarray      # [NSW, fan_max] compact indices of feeding
    #   emitters, ascending, padded with EQ
    in_pos: np.ndarray      # [EQ] compact emitter's flat slot
    #   sw * fan_max + k in in_tbl

    # ---- queue-id helpers (block bases precomputed in build_topology) ----

    def t0_up(self, r: int, a: int) -> int:
        return r * self.tree.uplinks + a

    def t1_up(self, s1: int, j: int) -> int:
        """T1 switch ``s1`` (pod-major: g * uplinks + a), core uplink j."""
        t = self.tree
        if not t.pods:
            raise ValueError("t1_up ports exist only on three-tier trees")
        return t.racks * t.uplinks + s1 * t.core_uplinks + j

    def t2_down(self, c: int, g: int) -> int:
        """Core switch ``c`` (= a * core_uplinks + j), downlink to pod g."""
        t = self.tree
        if not t.pods:
            raise ValueError("t2_down ports exist only on three-tier trees")
        return (t.racks * t.uplinks + t.n_t1 * t.core_uplinks
                + c * t.pods + g)

    def t1_down(self, s1: int, i: int) -> int:
        """T1 switch ``s1``'s downlink to its i-th rack (two-tier: spine
        s1's downlink to rack i — the historical (k, r) layout)."""
        t = self.tree
        base = (t.racks * t.uplinks + t.n_t1 * t.core_uplinks
                + t.n_cores * t.pods)
        return base + s1 * t.racks_per_pod + i

    def t0_down(self, node: int) -> int:
        return self.n_queues - self.tree.n_nodes + node

    def sender(self, node: int) -> int:
        return self.n_queues + node

    # ---- switch-id helpers ----

    def rack_sw(self, r: int) -> int:
        return r

    def t1_sw(self, s1: int) -> int:
        return self.tree.racks + s1

    def core_sw(self, c: int) -> int:
        return self.tree.racks + self.tree.n_t1 + c


def build_topology(tree: FatTreeConfig) -> Topology:
    P, U1, M, N = tree.racks, tree.uplinks, tree.nodes_per_rack, tree.n_nodes
    three = tree.tiers == 3
    G = tree.pods if three else 1
    Pg = tree.racks_per_pod                  # racks per T1 subtree
    U2 = tree.core_uplinks
    NA = tree.n_t1                           # T1 switch count
    C = tree.n_cores

    b_t1up = P * U1
    b_t2dn = b_t1up + NA * U2
    b_t1dn = b_t2dn + C * G
    b_t0dn = b_t1dn + NA * Pg
    nq = b_t0dn + N
    ne = nq + N

    kind = np.zeros(ne, np.int32)
    rack = np.zeros(ne, np.int32)
    aux = np.zeros(ne, np.int32)
    nbr = np.full(ne, HOST, np.int32)

    nsw = P + NA + C
    sw_tier = np.zeros(nsw, np.int32)
    sw_lo = np.zeros(nsw, np.int32)
    sw_hi = np.zeros(nsw, np.int32)
    sw_up_base = np.zeros(nsw, np.int32)
    sw_up_cnt = np.zeros(nsw, np.int32)
    node_rack = np.arange(N, dtype=np.int32) // M

    # ---- switches ----
    for r in range(P):
        sw_tier[r] = 0
        sw_lo[r], sw_hi[r] = r * M, (r + 1) * M
        sw_up_base[r], sw_up_cnt[r] = r * U1, U1
    for s1 in range(NA):
        sw = P + s1
        sw_tier[sw] = 1
        if three:
            g = s1 // U1
            sw_lo[sw], sw_hi[sw] = g * Pg * M, (g + 1) * Pg * M
            sw_up_base[sw] = b_t1up + s1 * U2
            sw_up_cnt[sw] = U2
        else:
            sw_lo[sw], sw_hi[sw] = 0, N     # spine: whole fabric below
    for c in range(C):
        sw = P + NA + c
        sw_tier[sw] = 2
        sw_lo[sw], sw_hi[sw] = 0, N
    sw_salt = (np.arange(nsw, dtype=np.uint32) * np.uint32(SALT_MUL)
               + np.uint32(SALT_ADD))

    # ---- down-port rules ----
    # At every tier a switch's down ports cover its subtree in equal-length
    # runs of nodes, so the port toward node d is the run-length lookup
    # dn_base + d // dn_stride (exact for every d inside the subtree, which
    # is the only place routing ever goes down).  The dense table is kept,
    # numpy-only, as the reference form for tests/tools; rows are exact
    # inside the switch's subtree, entries outside it are never routed to.
    dn_base = np.zeros(nsw, np.int32)
    dn_stride = np.ones(nsw, np.int32)
    dn_base[:P] = b_t0dn                         # rack: one port per node
    for s1 in range(NA):
        g = s1 // U1 if three else 0             # subtree starts at rack g*Pg
        dn_base[P + s1] = b_t1dn + s1 * Pg - g * Pg
        dn_stride[P + s1] = M                    # one port per rack
    for c in range(C):
        dn_base[P + NA + c] = b_t2dn + c * G
        dn_stride[P + NA + c] = M * Pg           # one port per pod
    down_tbl = np.zeros((nsw, N), np.int32)
    down_tbl[:P] = b_t0dn + np.arange(N, dtype=np.int32)[None, :]
    for s1 in range(NA):
        if three:
            g = s1 // U1
            i = np.clip(node_rack - g * Pg, 0, Pg - 1)
        else:
            i = node_rack
        down_tbl[P + s1] = b_t1dn + s1 * Pg + i
    for c in range(C):
        down_tbl[P + NA + c] = b_t2dn + c * G + node_rack // Pg

    # ---- ports ----
    sw_of_q = np.zeros(nq, np.int32)
    for r in range(P):
        for a in range(U1):
            q = r * U1 + a
            kind[q], rack[q], aux[q] = KIND_T0_UP, r, a
            nbr[q] = P + ((r // Pg) * U1 + a if three else a)
            sw_of_q[q] = r
    for s1 in range(NA):
        for j in range(U2):
            q = b_t1up + s1 * U2 + j
            kind[q], rack[q], aux[q] = KIND_T1_UP, s1, j
            nbr[q] = P + NA + (s1 % U1) * U2 + j
            sw_of_q[q] = P + s1
    for c in range(C):
        for g in range(G):
            q = b_t2dn + c * G + g
            kind[q], rack[q], aux[q] = KIND_T2_DOWN, c, g
            nbr[q] = P + g * U1 + c // U2
            sw_of_q[q] = P + NA + c
    for s1 in range(NA):
        for i in range(Pg):
            q = b_t1dn + s1 * Pg + i
            r = (s1 // U1) * Pg + i if three else i
            kind[q], rack[q], aux[q] = KIND_T1_DOWN, r, s1
            nbr[q] = r
            sw_of_q[q] = P + s1
    for n in range(N):
        q = b_t0dn + n
        kind[q], rack[q], aux[q] = KIND_T0_DOWN, n // M, n
        sw_of_q[q] = n // M
    for n in range(N):
        e = nq + n
        kind[e], rack[e], aux[e] = KIND_SENDER, n // M, n
        nbr[e] = n // M

    # ---- compact enqueue emitters + per-switch fan-in groups ----
    # Ascending emitter order inside each group: the enqueue rank of an
    # emitter is the count of *smaller-id* emitters enqueueing to the same
    # queue, and same-queue emitters always share a feeding switch, so the
    # in-group slot order reproduces the global emitter order exactly.
    # Groups index the *compact* enumeration (also ascending, so the order
    # argument carries over verbatim): the whole enqueue path then runs on
    # EQ = ne - N rows instead of ne.
    enq_ids = np.where(nbr >= 0)[0].astype(np.int32)
    eq = len(enq_ids)
    compact = np.full(ne, eq, np.int32)
    compact[enq_ids] = np.arange(eq, dtype=np.int32)
    fan = [[] for _ in range(nsw)]
    for e in enq_ids:
        fan[nbr[e]].append(int(compact[e]))
    fan_max = max(len(g) for g in fan)
    in_tbl = np.full((nsw, fan_max), eq, np.int32)
    in_pos = np.zeros(eq, np.int32)
    for s, group in enumerate(fan):
        for k, j in enumerate(group):
            in_tbl[s, k] = j
            in_pos[j] = s * fan_max + k

    return Topology(tree=tree, n_queues=nq, n_emitters=ne, n_switches=nsw,
                    kind=kind, rack=rack, aux=aux, nbr_sw=nbr,
                    sw_tier=sw_tier, sw_lo=sw_lo, sw_hi=sw_hi,
                    sw_up_base=sw_up_base, sw_up_cnt=sw_up_cnt,
                    sw_salt=sw_salt, down_tbl=down_tbl,
                    dn_base=dn_base, dn_stride=dn_stride, sw_of_q=sw_of_q,
                    enq_ids=enq_ids, fan_max=fan_max, in_tbl=in_tbl,
                    in_pos=in_pos)
