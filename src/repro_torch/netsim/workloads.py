"""Traffic patterns from the paper's evaluation (Sec. 4): incast,
permutation (including multi-permutation and uneven-size variants), and
windowed alltoall — plus the sparse large-message patterns
(``heavy_tailed``, ``staggered_large``) that exercise the engine's
event-horizon time leaping (DESIGN.md Sec. 6.3): heavy-tailed message
sizes and spread-out arrivals keep the fabric quiescent for most of the
simulated span.

A workload is a static flow table.  ``window`` implements the paper's
windowed alltoall (Sec. 4.5): a sender's flow with per-sender order index j
becomes eligible only while fewer than ``window`` of its predecessors are
unfinished, keeping k flows active per node at all times.

Dependency-driven traffic (collectives — DESIGN.md Sec. 11) rides on the
optional ``dep_par``/``dep_thr`` table: flow ``f`` activates only once
``t >= t_start[f]`` *and* every parent ``dep_par[f, j]`` has delivered at
least ``dep_thr[f, j]`` bytes to its receiver (slot sentinel ``-1`` =
unused).  ``coll_id`` groups flows into collectives for the CCT metric;
it never reaches the device.  ``netsim/collectives.py`` emits these
tables for ring/tree allreduce, all-gather, and pipeline patterns.

``Workload.validate()`` sanity-checks a table (self-flows, sizes, start
ticks, node bounds, window/order consistency, dependency shape/range/
threshold bounds and DAG acyclicity via Kahn's algorithm) with actionable
errors; ``state.derive`` calls it before any shape math, so hand-built
tables fail fast instead of deep inside tracing.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.netsim.units import FatTreeConfig


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    src: np.ndarray          # [F] i32 sender node
    dst: np.ndarray          # [F] i32 receiver node
    size: np.ndarray         # [F] i32 bytes
    t_start: np.ndarray      # [F] i32 tick
    order: np.ndarray        # [F] i32 per-sender flow ordinal (alltoall windowing)
    window: int = 1 << 30    # flows eligible per sender at once
    # -- optional dependency table (collectives; None = legacy t_start-only)
    dep_par: np.ndarray | None = None   # [F, D] i32 parent flow id (-1 = free)
    dep_thr: np.ndarray | None = None   # [F, D] i32 parent bytes that must
                                        #   have landed before this flow starts
    coll_id: np.ndarray | None = None   # [F] i32 collective group (-1 = none);
                                        #   host-only — drives the CCT metric

    @property
    def n_flows(self) -> int:
        return int(self.src.shape[0])

    @property
    def n_deps(self) -> int:
        """Dependency-table width D (0 = no table)."""
        return 0 if self.dep_par is None else int(self.dep_par.shape[1])

    def validate(self, n_nodes: int | None = None) -> "Workload":
        """Check the flow table before it reaches tracing.

        ``state.derive`` calls this with the topology's node count; call
        it directly after hand-building a table.  Raises ``ValueError``
        with the offending flow indices — a bad table otherwise fails
        deep inside jit tracing with a shape or gather error.  Returns
        ``self`` so construction can chain.
        """
        fields = {"src": self.src, "dst": self.dst, "size": self.size,
                  "t_start": self.t_start, "order": self.order}
        for key, arr in fields.items():
            a = np.asarray(arr)
            if a.ndim != 1:
                raise ValueError(
                    f"workload {self.name!r}: field {key!r} must be 1-D "
                    f"[n_flows], got shape {a.shape}")
            if a.shape[0] != self.src.shape[0]:
                raise ValueError(
                    f"workload {self.name!r}: field {key!r} has "
                    f"{a.shape[0]} entries but src has {self.src.shape[0]}; "
                    f"all flow-table columns must align")
        if self.n_flows == 0:
            raise ValueError(
                f"workload {self.name!r}: empty flow table (the engine "
                f"needs at least one flow)")

        def _idx(mask):
            return np.flatnonzero(mask)[:8].tolist()

        self_talk = self.src == self.dst
        if np.any(self_talk):
            raise ValueError(
                f"workload {self.name!r}: flows {_idx(self_talk)} have "
                f"src == dst (a node cannot send to itself); fix the "
                f"traffic table")
        bad_size = self.size <= 0
        if np.any(bad_size):
            raise ValueError(
                f"workload {self.name!r}: flows {_idx(bad_size)} have "
                f"non-positive size; every flow must move >= 1 byte")
        bad_start = self.t_start < 0
        if np.any(bad_start):
            raise ValueError(
                f"workload {self.name!r}: flows {_idx(bad_start)} have "
                f"negative t_start; start ticks must be >= 0")
        oob = (self.src < 0) | (self.dst < 0)
        if n_nodes is not None:
            oob |= (self.src >= n_nodes) | (self.dst >= n_nodes)
        if np.any(oob):
            bound = f"[0, {n_nodes})" if n_nodes is not None else ">= 0"
            raise ValueError(
                f"workload {self.name!r}: flows {_idx(oob)} reference "
                f"nodes outside {bound}; the workload was built for a "
                f"different topology")
        self._validate_deps(_idx)
        # Windowing admits a sender's flows in `order`: a flow becomes
        # eligible once fewer than `window` of its order-predecessors are
        # unfinished.  If a window-gated flow (order index >= window —
        # earlier ones can never accumulate `window` unfinished
        # predecessors) starts *earlier* than a predecessor, the window
        # would hold it past its own start time — almost always a
        # mis-built table, so reject it for every sender the window can
        # actually gate (more flows than `window`).
        if self.window >= self.n_flows:      # windowing can't gate anyone
            return self
        senders, counts = np.unique(self.src, return_counts=True)
        for s in senders[counts > self.window]:
            f = np.flatnonzero(self.src == s)
            f = f[np.argsort(self.order[f], kind="stable")]
            drop = np.diff(self.t_start[f]) < 0
            drop[:max(self.window - 1, 0)] = False   # later flow ungated
            if np.any(drop):
                j = int(np.flatnonzero(drop)[0])
                raise ValueError(
                    f"workload {self.name!r}: windowed sender {int(s)} "
                    f"has t_start decreasing along its `order` (flow "
                    f"{int(f[j + 1])} starts at "
                    f"{int(self.t_start[f[j + 1]])} < flow {int(f[j])} "
                    f"at {int(self.t_start[f[j]])}); sort t_start to "
                    f"match `order` (or widen `window`) so the "
                    f"eligibility window never blocks a flow past its "
                    f"start tick")
        return self

    def _validate_deps(self, _idx) -> None:
        """Dependency-table checks: shape alignment, parent-id range,
        threshold bounds, and DAG acyclicity (Kahn's algorithm)."""
        F = self.n_flows
        if (self.dep_par is None) != (self.dep_thr is None):
            have = "dep_par" if self.dep_par is not None else "dep_thr"
            raise ValueError(
                f"workload {self.name!r}: {have} set without its partner; "
                f"dep_par and dep_thr must be given together ([F, D] each)")
        if self.coll_id is not None:
            cid = np.asarray(self.coll_id)
            if cid.ndim != 1 or cid.shape[0] != F:
                raise ValueError(
                    f"workload {self.name!r}: coll_id must be 1-D [n_flows],"
                    f" got shape {cid.shape}")
            bad = cid < -1
            if np.any(bad):
                raise ValueError(
                    f"workload {self.name!r}: flows {_idx(bad)} have "
                    f"coll_id < -1; use -1 for flows outside any collective")
        if self.dep_par is None:
            return
        par = np.asarray(self.dep_par)
        thr = np.asarray(self.dep_thr)
        if par.ndim != 2 or par.shape[0] != F or thr.shape != par.shape:
            raise ValueError(
                f"workload {self.name!r}: dependency table must be two "
                f"aligned [n_flows, D] arrays; got dep_par {par.shape}, "
                f"dep_thr {thr.shape} for {F} flows")
        if par.shape[1] == 0:
            return
        used = par >= 0
        oob = used & (par >= F)
        if np.any(oob):
            rows = np.flatnonzero(oob.any(axis=1))[:8].tolist()
            raise ValueError(
                f"workload {self.name!r}: flows {rows} reference parent "
                f"flow ids outside [0, {F}); dep_par must name flows of "
                f"this workload (-1 = unused slot)")
        self_dep = used & (par == np.arange(F, dtype=np.int64)[:, None])
        if np.any(self_dep):
            rows = np.flatnonzero(self_dep.any(axis=1))[:8].tolist()
            raise ValueError(
                f"workload {self.name!r}: flows {rows} depend on "
                f"themselves; a flow cannot gate its own start")
        parent_size = np.where(used, np.asarray(self.size)[
            np.clip(par, 0, F - 1)], 1)
        bad_thr = used & ((thr < 1) | (thr > parent_size))
        if np.any(bad_thr):
            rows = np.flatnonzero(bad_thr.any(axis=1))[:8].tolist()
            raise ValueError(
                f"workload {self.name!r}: flows {rows} have dependency "
                f"thresholds outside [1, parent size] bytes; a threshold "
                f"above the parent's size can never be met")
        # Kahn's algorithm over parent -> child edges: anything left with
        # unresolved parents after the peel sits on (or behind) a cycle.
        indeg = used.sum(axis=1).astype(np.int64)
        children: list[list[int]] = [[] for _ in range(F)]
        for f, p in zip(*np.nonzero(used)):
            children[int(par[f, p])].append(int(f))
        queue = list(np.flatnonzero(indeg == 0))
        done = 0
        while queue:
            p = queue.pop()
            done += 1
            for c in children[p]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    queue.append(c)
        if done < F:
            stuck = np.flatnonzero(indeg > 0)[:8].tolist()
            raise ValueError(
                f"workload {self.name!r}: dependency cycle — flows "
                f"{stuck} can never activate (Kahn's algorithm leaves "
                f"them with unresolved parents); break the cycle in "
                f"dep_par")


def incast(tree: FatTreeConfig, degree: int, size_bytes: int, receiver: int = 0,
           seed: int = 0, start: int = 0) -> Workload:
    """`degree`:1 incast onto `receiver`, senders spread across racks."""
    n = tree.n_nodes
    if degree > n - 1:
        raise ValueError("incast degree exceeds node count")
    rng = np.random.default_rng(seed)
    # spread senders round-robin over racks so the fan-in crosses the core
    order = np.argsort((np.arange(n) % tree.nodes_per_rack) * tree.racks
                       + np.arange(n) // tree.nodes_per_rack, kind="stable")
    candidates = np.array([x for x in order if x != receiver], np.int32)
    src = candidates[:degree]
    rng.shuffle(src)
    f = degree
    return Workload(
        name=f"incast_{degree}to1",
        src=src.astype(np.int32),
        dst=np.full(f, receiver, np.int32),
        size=np.full(f, size_bytes, np.int32),
        t_start=np.full(f, start, np.int32),
        order=np.zeros(f, np.int32),
    )


def permutation(tree: FatTreeConfig, size_bytes: int, seed: int = 0,
                cross_rack: bool = True, n_perms: int = 1,
                big_flow: tuple[int, int] | None = None) -> Workload:
    """Node-to-node permutation(s).  ``cross_rack`` forces every flow through
    the core (paper: 'selected so that each packet crosses the core
    switches').  ``n_perms`` > 1 runs several concurrent permutations
    (Fig. 11c); ``big_flow=(idx, size)`` makes one flow bigger (Fig. 11d)."""
    n = tree.n_nodes
    rng = np.random.default_rng(seed)
    srcs, dsts, orders = [], [], []
    for pi in range(n_perms):
        if cross_rack:
            shift = tree.nodes_per_rack * (1 + rng.integers(0, tree.racks - 1))
            dst = (np.arange(n) + shift) % n
        else:
            dst = rng.permutation(n)
            while np.any(dst == np.arange(n)):
                dst = rng.permutation(n)
        srcs.append(np.arange(n))
        dsts.append(dst)
        orders.append(np.full(n, pi))
    src = np.concatenate(srcs).astype(np.int32)
    dst = np.concatenate(dsts).astype(np.int32)
    size = np.full(src.shape[0], size_bytes, np.int32)
    if big_flow is not None:
        size[big_flow[0]] = big_flow[1]
    return Workload(
        name=f"permutation_x{n_perms}",
        src=src,
        dst=dst,
        size=size,
        t_start=np.zeros_like(src),
        order=np.concatenate(orders).astype(np.int32),
    )


def heavy_tailed(tree: FatTreeConfig, n_flows: int, *,
                 size_base: int = 16 * 1024, alpha: float = 1.3,
                 size_cap: int = 2 * 1024 * 1024,
                 gap_mean: float = 4000.0, seed: int = 0) -> Workload:
    """Sparse arrivals with Pareto(``alpha``)-tailed message sizes.

    Flow ``i`` starts after an Exp(``gap_mean``)-distributed gap beyond
    flow ``i-1``'s start and moves ``size_base * Pareto`` bytes (capped at
    ``size_cap``) between a random src/dst pair — mostly short messages
    with a heavy tail of multi-BDP ones, separated by idle stretches of
    many base RTTs.  The time-stepped engine burns a tick per MTU-time
    across those stretches; the leap-enabled engine skips them in closed
    form, which is exactly what `benchmarks/perf.py` measures on this
    pattern (UEC-style sparse/large-message regimes, arXiv 2508.08906).
    """
    n = tree.n_nodes
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, n_flows)
    dst = rng.integers(0, n - 1, n_flows)
    dst += (dst >= src).astype(dst.dtype)          # uniform over dst != src
    size = np.minimum(size_base * (1.0 + rng.pareto(alpha, n_flows)),
                      size_cap).astype(np.int64)
    t_start = np.floor(np.cumsum(rng.exponential(gap_mean, n_flows))
                       ).astype(np.int64)
    t_start -= t_start[0]                          # first flow starts at 0
    return Workload(
        name=f"heavy_tailed_{n_flows}f",
        src=src.astype(np.int32),
        dst=dst.astype(np.int32),
        size=np.maximum(size, 1).astype(np.int32),
        t_start=t_start.astype(np.int32),
        order=np.zeros(n_flows, np.int32),
    )


def staggered_large(tree: FatTreeConfig, n_flows: int, size_bytes: int,
                    gap_ticks: int, seed: int = 0) -> Workload:
    """Few large messages, launched one every ``gap_ticks``.

    Every flow has its own sender and its own receiver (a node may still
    send one flow while receiving another), and every pair is cross-rack;
    with ``gap_ticks`` well above the per-message service time the fabric
    is idle between transfers — the timeout/large-message regime the leap
    engine targets."""
    n, m = tree.n_nodes, tree.nodes_per_rack
    if n_flows > n // 2:
        raise ValueError("staggered_large wants at most n_nodes/2 flows "
                         "(one sender and one receiver per flow)")
    rng = np.random.default_rng(seed)
    # pair node i with a node shifted one rack over; distinct flows use
    # distinct senders (FMAX stays 1) and distinct receivers
    perm = rng.permutation(n)
    src = perm[:n_flows]
    dst = (src + m) % n
    return Workload(
        name=f"staggered_{n_flows}x{size_bytes // 1024}K",
        src=src.astype(np.int32),
        dst=dst.astype(np.int32),
        size=np.full(n_flows, size_bytes, np.int32),
        t_start=(gap_ticks * np.arange(n_flows)).astype(np.int32),
        order=np.zeros(n_flows, np.int32),
    )


def alltoall(tree: FatTreeConfig, size_bytes: int, window: int = 4,
             nodes: int | None = None, seed: int = 0,
             spread: bool = False) -> Workload:
    """Windowed alltoall among ``nodes`` hosts (Sec. 4.5).  Participants
    are the first ``nodes`` hosts, or — with ``spread`` — evenly strided
    across the whole fabric, so on a large multi-tier tree the collective
    actually crosses racks, pods, and the core instead of staying inside
    the first racks."""
    n = nodes or tree.n_nodes
    stride = tree.n_nodes // n if spread else 1
    ids = np.arange(n, dtype=np.int32) * stride
    srcs, dsts, orders = [], [], []
    for s in range(n):
        # classic shifted schedule: round j targets (s + j) mod n
        for j in range(1, n):
            srcs.append(ids[s])
            dsts.append(ids[(s + j) % n])
            orders.append(j - 1)
    f = len(srcs)
    return Workload(
        name=f"alltoall_{n}x{n}_w{window}",
        src=np.array(srcs, np.int32),
        dst=np.array(dsts, np.int32),
        size=np.full(f, size_bytes, np.int32),
        t_start=np.zeros(f, np.int32),
        order=np.array(orders, np.int32),
        window=window,
    )
