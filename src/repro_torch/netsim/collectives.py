"""Dependency-driven collective traffic generators (DESIGN.md Sec. 11).

AI-datacenter traffic is collectives — ring/tree allreduce, all-gather,
pipeline stages — not independent flow lists: each transfer starts only
when the chunk it consumes has landed (PAPER.md; Hoefler et al. 2025,
"Ultra Ethernet's Design Principles").  This module emits plain
:class:`Workload` tables whose ``dep_par``/``dep_thr`` columns encode
that chunk DAG; the engine's ``sender.activated`` predicate releases each
flow the tick its last prerequisite byte is delivered, and the ``coll_id``
column groups flows so ``api.RunResult`` can report collective completion
time (CCT) next to FCT.

Host-side numpy only: these run per scenario build, never on the device.
The tables are the reference's (``repro/netsim/collectives.py``) byte for
byte.

Generators:

  ``ring_allreduce``  bucket algorithm: N-1 reduce-scatter steps then
                      N-1 all-gather steps around a ring; every node
                      forwards one chunk per step, each send gated on the
                      previous step's chunk landing from the ring
                      predecessor (D = 1).
  ``all_gather``      the ring all-gather phase alone (N-1 steps).
  ``tree_allreduce``  reduce up a ``branching``-ary tree (a node's upward
                      send waits on all children's chunks, D = branching)
                      then broadcast back down.
  ``pipeline``        M microbatches through S linearly-chained stages;
                      stage s of microbatch m waits on stage s-1 of the
                      same microbatch.
"""

from __future__ import annotations

import numpy as np

from repro_torch.netsim.units import FatTreeConfig
from repro_torch.netsim.workloads import Workload


def _participants(tree: FatTreeConfig, nodes: int | None,
                  spread: bool) -> np.ndarray:
    """The first ``nodes`` hosts, or — with ``spread`` — evenly strided
    across the fabric so the collective crosses racks/pods/core."""
    n = nodes or tree.n_nodes
    if n < 2 or n > tree.n_nodes:
        raise ValueError(
            f"collective wants 2 <= nodes <= {tree.n_nodes}, got {n}")
    stride = tree.n_nodes // n if spread else 1
    return np.arange(n, dtype=np.int64) * stride


def _table(name: str, rows: list, coll: int = 0) -> Workload:
    """Assemble (src, dst, size, t_start, dep, order) rows into a
    Workload.  ``rows`` entries are (src, dst, size, t_start, deps) with
    ``deps`` a list of (parent_flow, threshold_bytes)."""
    F = len(rows)
    D = max((len(r[4]) for r in rows), default=0)
    src = np.fromiter((r[0] for r in rows), np.int32, F)
    dst = np.fromiter((r[1] for r in rows), np.int32, F)
    size = np.fromiter((r[2] for r in rows), np.int32, F)
    t_start = np.fromiter((r[3] for r in rows), np.int32, F)
    dep_par = np.full((F, D), -1, np.int32)
    dep_thr = np.zeros((F, D), np.int32)
    for f, r in enumerate(rows):
        for j, (p, thr) in enumerate(r[4]):
            dep_par[f, j] = p
            dep_thr[f, j] = thr
    # per-sender emission order follows flow id (the step/phase order the
    # generators emit in), so round-robin arbitration visits a sender's
    # earliest-releasable flow first
    order = np.zeros(F, np.int32)
    cnt: dict[int, int] = {}
    for f in range(F):
        s = int(src[f])
        order[f] = cnt.get(s, 0)
        cnt[s] = order[f] + 1
    return Workload(
        name=name, src=src, dst=dst, size=size, t_start=t_start,
        order=order, dep_par=dep_par, dep_thr=dep_thr,
        coll_id=np.full(F, coll, np.int32))


def ring_allreduce(tree: FatTreeConfig, chunk_bytes: int,
                   nodes: int | None = None, spread: bool = False,
                   start: int = 0) -> Workload:
    """Bucket ring allreduce over ``nodes`` participants.

    2(N-1) steps; at step s every node i sends one ``chunk_bytes`` chunk
    to its ring successor, gated (for s > 0) on the chunk it forwards
    having arrived from its ring predecessor at step s-1.  Steps
    [0, N-1) are the reduce-scatter phase, [N-1, 2(N-1)) the all-gather
    phase — same traffic pattern, one dependency chain."""
    ids = _participants(tree, nodes, spread)
    n = len(ids)
    steps = 2 * (n - 1)
    rows = []
    fid = {}                       # (i, s) -> flow id
    for s in range(steps):
        for i in range(n):
            deps = []
            if s > 0:
                deps.append((fid[(i - 1) % n, s - 1], chunk_bytes))
            fid[i, s] = len(rows)
            rows.append((ids[i], ids[(i + 1) % n], chunk_bytes, start, deps))
    return _table(f"allreduce_ring_{n}n", rows)


def all_gather(tree: FatTreeConfig, chunk_bytes: int,
               nodes: int | None = None, spread: bool = False,
               start: int = 0) -> Workload:
    """Ring all-gather: N-1 steps, each node forwarding the chunk it just
    received (step 0 sends its own shard, dependency-free)."""
    ids = _participants(tree, nodes, spread)
    n = len(ids)
    rows = []
    fid = {}
    for s in range(n - 1):
        for i in range(n):
            deps = []
            if s > 0:
                deps.append((fid[(i - 1) % n, s - 1], chunk_bytes))
            fid[i, s] = len(rows)
            rows.append((ids[i], ids[(i + 1) % n], chunk_bytes, start, deps))
    return _table(f"allgather_{n}n", rows)


def tree_allreduce(tree: FatTreeConfig, msg_bytes: int,
                   nodes: int | None = None, spread: bool = False,
                   branching: int = 2, start: int = 0) -> Workload:
    """Reduce-up + broadcast-down over a ``branching``-ary logical tree
    (heap layout: node k's children are ``branching*k + 1 ...``).

    Every non-root participant sends its reduced message to its tree
    parent once all of its own children's messages have landed
    (D = branching), then receives the broadcast copy gated on the
    parent's own inbound broadcast (the root's children instead wait on
    the root's reduction completing)."""
    if branching < 1:
        raise ValueError(f"branching must be >= 1, got {branching}")
    ids = _participants(tree, nodes, spread)
    n = len(ids)
    kids = [[c for c in range(branching * k + 1,
                              min(branching * k + 1 + branching, n))]
            for k in range(n)]
    rows = []
    red = {}                       # participant k -> its upward flow id
    # reduce phase: deepest-first so a flow's children exist before it —
    # emit in reverse heap order (children have larger heap indices)
    for k in range(n - 1, 0, -1):
        deps = [(red[c], msg_bytes) for c in kids[k]]
        red[k] = len(rows)
        rows.append((ids[k], ids[(k - 1) // branching], msg_bytes, start,
                     deps))
    # broadcast phase: top-down; child k's copy comes from its parent,
    # gated on the parent's inbound broadcast (root: on the reduction)
    bcast = {}
    for k in range(1, n):
        parent = (k - 1) // branching
        if parent == 0:
            deps = [(red[c], msg_bytes) for c in kids[0]]
        else:
            deps = [(bcast[parent], msg_bytes)]
        bcast[k] = len(rows)
        rows.append((ids[parent], ids[k], msg_bytes, start, deps))
    return _table(f"allreduce_tree_{n}n_b{branching}", rows)


def pipeline(tree: FatTreeConfig, stage_bytes: int, stages: int,
             microbatches: int, spread: bool = False,
             start: int = 0) -> Workload:
    """M microbatches through a linear chain of ``stages`` nodes.

    Flow (m, s) moves microbatch m's activations from stage node s to
    s+1 and waits on (m, s-1) landing (D = 1); the stage-0 flows are
    dependency-free and all start at ``start`` — the per-sender
    round-robin serializes them in microbatch order."""
    if stages < 2 or microbatches < 1:
        raise ValueError(
            f"pipeline wants stages >= 2 and microbatches >= 1, got "
            f"{stages} stages x {microbatches} microbatches")
    ids = _participants(tree, stages, spread)
    rows = []
    fid = {}
    for s in range(stages - 1):
        for m in range(microbatches):
            deps = []
            if s > 0:
                deps.append((fid[m, s - 1], stage_bytes))
            fid[m, s] = len(rows)
            rows.append((ids[s], ids[s + 1], stage_bytes, start, deps))
    return _table(f"pipeline_{stages}s_{microbatches}m", rows)
