"""Experiment API: one declarative entry point for runs, seed batches,
and parameter sweeps (DESIGN.md Sec. 7), on the port's engine::

    res = run("incast8_32n")                      # one run -> RunResult
    res = study("perm64",                          # P x S grid -> StudyResult
                points=[{"start_cwnd_mult": a} for a in (0.5, 1.0, 1.25)],
                seeds=range(4)).run()

The names, the sweep-point vocabulary, the result types and their
metrics are the reference's (``repro/netsim/api.py``).  Runs go on the
card unless the caller asks for the CPU (``device="cpu"``).

A :class:`Study` holds the reference's lane-batched constants: every
``Consts`` leaf that differs across points gets a leading ``[P*S]`` axis
in point-major order (axis 0), every leaf equal across points stays
shared (axis ``None``) — ``_stack_consts``.  Its lanes run as one batch on
the card (``netsim/shard.py``: one launch of each fused tick kernel a
batched tick, for all live lanes, each lane gated and leaping on its
own), and every lane equals the standalone ``Sim.run`` of its (point,
seed) bit for bit, as in the reference.  A config that names an earlier
design's backend (``departures_backend="plain"``, a ``"split"`` one) runs
one lane only and raises at plan time.

``Study.run`` keeps the reference's ``cache=`` (``netsim/cache.py``, the
lanes content-addressed) and ``chunk_lanes=`` (flush each finished chunk
to the cache, so a killed grid resumes), and ``mesh=``: the lanes spread
over several devices, one lane loop a shard (``netsim/shard.py``), each
lane bit-equal to the one-device batch.

Every metric is numpy arithmetic on host copies of the final state, as
in the reference: no divide of a tensor appears in a result.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Mapping

import numpy as np
import torch

from repro_torch.analysis.trace_guard import Recording, profiled, span
from repro_torch.netsim import cache as cache_mod
from repro_torch.netsim import engine, faults as faults_mod, scenarios, shard, state
from repro_torch.netsim.metrics import jain_fairness
from repro_torch.netsim.scenarios import Scenario

# --------------------------------------------------------------------------
# sweep points
# --------------------------------------------------------------------------

# make_cc_params tuning kwargs routable through SimConfig.cc_overrides
CC_PARAM_KEYS = frozenset({
    "target_mult", "fd", "md", "fi", "k_fast", "qa_scaling", "wtd_alpha",
    "wtd_thresh", "fi_rtt_tol", "maxcwnd_mult", "sw_ai", "sw_beta",
    "sw_max_mdf",
})
# numeric SimConfig fields that stay inside Consts (no Dims impact)
CFG_KEYS = frozenset({
    "rto_mult", "react_every", "credit_window_mult", "start_cwnd_mult",
    "kmin_frac", "kmax_frac", "num_entropies", "fault_start",
    "goodput_bin",
})
# SimConfig fields that change Dims or the tick's branches — never
# sweepable; vary the Scenario instead (one build per value).  The backend
# selectors swap whole kernel implementations, the port's two extra ones
# (departures_backend, sender_backend) included.
STATIC_KEYS = frozenset({
    "link", "tree", "algo", "cc_backend", "departures_backend",
    "fabric_backend", "sender_backend", "transport_backend", "lb",
    "superstep", "leap", "trimming", "faults", "cc_overrides",
    "rto_backoff_max", "evict_on_timeout",
})

# One flow's receiver-side trimmed bytes (``trim_seen``) stay exact while
# they are an integer below 2**24: the port's arrivals phase adds a flow's
# rejected bytes once, in integers, the reference each packet in f32
# (kernels/arrivals/ref.py).  Past it the two can differ.
TRIM_SEEN_LIMIT = 1 << 24


def apply_point(cfg: state.SimConfig, point: Mapping[str, float]) -> state.SimConfig:
    """Fold one sweep point into a SimConfig (cc keys -> cc_overrides)."""
    cfg_kw = {}
    cc = dict(cfg.cc_overrides)
    for k, v in dict(point).items():
        if k in CFG_KEYS:
            cfg_kw[k] = v
        elif k in CC_PARAM_KEYS:
            cc[k] = v
        elif k in STATIC_KEYS:
            raise KeyError(
                f"key {k!r} changes Dims (shapes/branches) and cannot be "
                f"swept inside one study; build one Scenario per value "
                f"instead (scenario(name, {k}=...))")
        else:
            raise KeyError(
                f"unsweepable key {k!r}; numeric keys are "
                f"{sorted(CFG_KEYS | CC_PARAM_KEYS)}")
    return dataclasses.replace(cfg, cc_overrides=tuple(sorted(cc.items())),
                               **cfg_kw)


def _norm_point(point) -> tuple:
    """Normalize a sweep point to sorted ``((key, value), ...)``."""
    return tuple(sorted(dict(point).items()))


def point_tag(point) -> str:
    """Human/ledger tag for a sweep point (``"base"`` for the empty one)."""
    kv = _norm_point(point)
    return "+".join(f"{k}={v:g}" for k, v in kv) if kv else "base"


# --------------------------------------------------------------------------
# Consts lane batching
# --------------------------------------------------------------------------


no_axes = state.no_axes


def _stack_consts(consts_list, repeats: int):
    """Stack per-point Consts into a lane batch.

    Leaves equal across points stay unbatched (axis ``None``); varying
    leaves are stacked to ``[P]`` and repeated ``repeats`` times along axis
    0 to ``[P*repeats]`` (point-major lane order).  Returns ``(consts_b,
    axes)``, ``axes`` the matching tree of 0 / None."""
    flats = [state.tree_leaves(c) for c in consts_list]
    leaves, axes = [], []
    for slot in zip(*flats):
        x0 = slot[0]
        if all(x.shape == x0.shape and torch.equal(x, x0) for x in slot[1:]):
            leaves.append(x0)
            axes.append(None)
        else:
            stacked = torch.stack(slot)
            leaves.append(stacked.repeat_interleave(repeats, dim=0)
                          if repeats > 1 else stacked)
            axes.append(0)
    template = consts_list[0]
    return state.tree_unflatten(template, leaves), state.tree_unflatten(template, axes)


# --------------------------------------------------------------------------
# typed results
# --------------------------------------------------------------------------


def _flow_meta(sim: engine.Sim) -> dict:
    """Host copies of the per-flow constants a RunResult carries.
    ``coll_id`` is host-only workload metadata — it groups flows into
    collectives for the CCT metric."""
    return dict(size=sim.consts.size.cpu().numpy(),
                t_start=sim.consts.t_start.cpu().numpy(),
                flow_brtt=sim.consts.cc.brtt.cpu().numpy(),
                coll_id=(None if sim.wl.coll_id is None
                         else np.asarray(sim.wl.coll_id)))


def check_trim_seen(sim: engine.Sim, st) -> None:
    """Raise where a credit-based run (eqds, eqds_smartt) holds a flow
    whose ``trim_seen`` reached ``TRIM_SEEN_LIMIT``: past it the port's
    integer staging and the reference's f32 adds can differ."""
    if sim.dims.credit_based:
        worst = float(np.max(st.trim_seen))
        if worst >= TRIM_SEEN_LIMIT:
            raise ValueError(
                f"trim_seen reached {worst:.0f} bytes >= 2**24 in a "
                f"{sim.cfg.algo} run: the port adds a flow's rejected bytes "
                f"to trim_seen once in integers where the reference adds "
                f"each packet in f32, and the two agree only below 2**24 "
                f"(ROADMAP.md Queue 3)")


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class RunResult:
    """Typed summary of one finished run (one lane of a study).

    Per-flow arrays are host-side numpy; ``state`` keeps the full final
    ``SimState`` as a host copy (numpy leaves) for tests and deeper
    digging (excluded from ``row()``)."""

    scenario: str
    algo: str
    lb: str
    point: tuple              # normalized ((key, value), ...), () = base
    seed: int
    max_ticks: int
    ticks: int                # this lane's own final `now`
    mtu: int
    brtt: int                 # base RTT ticks == BDP packets
    fct: np.ndarray           # i32 [NF], -1 = unfinished
    goodput: np.ndarray       # i32 [NF] unique bytes delivered
    done: np.ndarray          # bool [NF]
    size: np.ndarray          # i32 [NF] flow bytes
    t_start: np.ndarray       # i32 [NF]
    flow_brtt: np.ndarray     # f32 [NF] per-flow base RTT (hop-specific)
    trims: int
    drops: int
    blackholed: int
    timeouts: int
    retx: int
    acks: int
    spurious_retx: int
    delivered_pkts: int
    delivered_bytes: float
    rtt_hist: np.ndarray
    q_mean: float
    q_max: int
    # collective grouping (None when the workload has no coll_id column)
    coll_id: np.ndarray | None = None   # i32 [NF], -1 = not in a collective
    # recovery metrics (zero/empty when the config has no fault schedule)
    delivered_bytes_fault: float = 0.0
    goodput_hist: np.ndarray | None = None  # f32 [GOODPUT_BINS] binned bytes
    goodput_bin: int = 0      # histogram bin width (ticks)
    fault_ticks: int = 0      # ticks in [0, ticks) with any port unhealthy
    repair_ticks: tuple = ()  # schedule transitions back to all-healthy
    first_fault: int = -1     # first fault-active tick (-1 = never)
    wall_s: float | None = None
    state: state.SimState | None = dataclasses.field(default=None)

    @classmethod
    def from_state(cls, sim: engine.Sim, st: state.SimState, *,
                   scenario: str, point=(), seed: int = 0,
                   max_ticks: int, wall_s: float | None = None,
                   flow_meta: dict | None = None) -> "RunResult":
        """Build from a final state, on the device or already on the host;
        it is copied to the host once (``state.to_numpy``).  ``flow_meta``
        lets a Study hoist the per-flow constants out of its lane loop.
        A credit-based run whose ``trim_seen`` reached 2**24 raises
        (:func:`check_trim_seen`)."""
        st = state.to_numpy(st)
        check_trim_seen(sim, st)
        if flow_meta is None:
            flow_meta = _flow_meta(sim)
        m = st.m
        now = int(st.now)
        # the fault schedule's activity is static (the schedule times a
        # possibly point-swept fault_start), so fault_ticks and the repair
        # anchors integrate on the host exactly
        pt = dict(_norm_point(point))
        eff_fs = int(pt.get("fault_start", sim.cfg.fault_start))
        eff_gb = (int(pt.get("goodput_bin", sim.cfg.goodput_bin))
                  or 8 * sim.dims.brtt_inter)
        sched = faults_mod.lower(sim.cfg.faults)
        if sched:
            cf = faults_mod.compile_tables(sched, sim.topo, eff_fs)
            fault_meta = dict(
                fault_ticks=faults_mod.fault_ticks(cf, eff_fs, now),
                repair_ticks=tuple(faults_mod.repair_times(cf, eff_fs, now)),
                first_fault=faults_mod.first_fault_time(cf, eff_fs, now),
            )
        else:
            fault_meta = {}
        return cls(
            scenario=scenario, algo=sim.cfg.algo, lb=sim.cfg.lb,
            point=_norm_point(point), seed=int(seed), max_ticks=int(max_ticks),
            ticks=now, mtu=sim.dims.mtu, brtt=sim.dims.brtt_inter,
            fct=st.fct, goodput=st.goodput, done=st.done, **flow_meta,
            trims=int(m.n_trim), drops=int(m.n_drop),
            blackholed=int(m.n_black), timeouts=int(m.n_to),
            retx=int(m.n_retx), acks=int(m.n_ack),
            spurious_retx=int(m.spurious_retx),
            delivered_pkts=int(m.delivered_pkts),
            delivered_bytes=float(m.delivered_bytes),
            rtt_hist=m.rtt_hist,
            q_mean=float(m.q_sum) / max(1, now) / sim.dims.NQ,
            q_max=int(m.q_max),
            delivered_bytes_fault=float(m.delivered_bytes_fault),
            goodput_hist=m.goodput_hist,
            goodput_bin=eff_gb, **fault_meta,
            wall_s=wall_s, state=st)

    # -- flow-level views ---------------------------------------------------

    @property
    def n_flows(self) -> int:
        return int(self.fct.shape[0])

    @property
    def n_done(self) -> int:
        return int(self.done.sum())

    @property
    def all_done(self) -> bool:
        return bool(self.done.all())

    @property
    def fct_done(self) -> np.ndarray:
        return self.fct[self.done]

    @property
    def completion(self) -> int:
        """Last flow-completion tick (-1 when nothing finished)."""
        return int(self.fct_done.max()) if self.n_done else -1

    @property
    def fct_min(self) -> int:
        return int(self.fct_done.min()) if self.n_done else -1

    @property
    def fct_mean(self) -> float:
        return float(self.fct_done.mean()) if self.n_done else -1.0

    @property
    def fct_p99(self) -> float:
        return float(np.percentile(self.fct_done, 99)) if self.n_done else -1.0

    @property
    def jain(self) -> float:
        """Jain fairness over finished-flow FCTs."""
        return jain_fairness(self.fct_done) if self.n_done else 0.0

    @property
    def ideal_fct(self) -> np.ndarray:
        """Per-flow uncongested lower bound: back-to-back serialization of
        ``ceil(size/mtu)`` packets plus that flow's base RTT (hop-count
        specific — intra-rack flows have a shorter one)."""
        pkts = -(-self.size.astype(np.int64) // self.mtu)
        return np.maximum(pkts - 1 + self.flow_brtt.astype(np.float64), 1.0)

    @property
    def slowdown(self) -> np.ndarray:
        """FCT slowdown vs the uncongested ideal (NaN for unfinished)."""
        s = self.fct / self.ideal_fct.astype(np.float64)
        return np.where(self.done, s, np.nan)

    @property
    def slowdown_mean(self) -> float:
        return (float(np.nanmean(self.slowdown)) if self.n_done else -1.0)

    @property
    def slowdown_p99(self) -> float:
        return (float(np.nanpercentile(self.slowdown, 99))
                if self.n_done else -1.0)

    @property
    def spurious_frac(self) -> float:
        return self.spurious_retx / max(1, self.delivered_pkts)

    # -- collective completion time (DESIGN.md Sec. 11) ---------------------

    @property
    def cct_by_coll(self) -> dict:
        """Per-collective completion time (CCT), keyed by ``coll_id``:
        ticks from the group's earliest ``t_start`` to its last flow's
        delivery (``max(fct + t_start) - min(t_start)`` over members);
        -1 while any member is unfinished.  Empty without a ``coll_id``
        column."""
        if self.coll_id is None:
            return {}
        out = {}
        finish = self.fct.astype(np.int64) + self.t_start
        for c in np.unique(self.coll_id[self.coll_id >= 0]):
            m = self.coll_id == c
            out[int(c)] = (int(finish[m].max() - self.t_start[m].min())
                           if self.done[m].all() else -1)
        return out

    @property
    def cct(self) -> int:
        """Slowest collective's CCT (-1: none defined, or any collective
        unfinished) — the scalar the bench ledger tracks."""
        ccts = self.cct_by_coll
        if not ccts or any(v < 0 for v in ccts.values()):
            return -1
        return max(ccts.values())

    # -- recovery metrics ---------------------------------------------------

    @property
    def delivered_fault_frac(self) -> float:
        """Fraction of delivered bytes that landed while the fault
        schedule was active (0.0 without faults)."""
        return self.delivered_bytes_fault / max(self.delivered_bytes, 1.0)

    def _goodput_rates(self):
        """(rates, n_bins): per-bin delivered bytes/tick over the run."""
        if self.goodput_hist is None or self.goodput_bin <= 0:
            return np.zeros(0), 0
        n = min(len(self.goodput_hist),
                -(-max(self.ticks, 1) // self.goodput_bin))
        return self.goodput_hist[:n] / float(self.goodput_bin), n

    @property
    def _baseline_rate(self) -> float:
        """Healthy goodput reference: mean rate over the bins fully
        before the first fault, falling back to the peak bin when the
        fault is active from tick 0."""
        rates, n = self._goodput_rates()
        if not n:
            return 0.0
        pre = self.first_fault // self.goodput_bin if self.first_fault > 0 \
            else 0
        if pre > 0:
            return float(rates[:pre].mean())
        return float(rates.max())

    @property
    def time_to_recover(self) -> tuple:
        """Per repair event: ticks from the repair until binned goodput
        first returns to >= 90% of the healthy baseline (-1 = never
        inside the run)."""
        rates, n = self._goodput_rates()
        base = self._baseline_rate
        out = []
        for r in self.repair_ticks:
            ttr = -1
            if n and base > 0:
                b0 = min(r // self.goodput_bin, n - 1)
                for b in range(b0, n):
                    if rates[b] >= 0.9 * base:
                        ttr = max((b + 1) * self.goodput_bin - r, 0)
                        break
            out.append(int(ttr))
        return tuple(out)

    @property
    def ttr_max(self) -> int:
        """Worst per-fault-event time-to-recover (-1: no repair events,
        or goodput never returned to baseline inside the run)."""
        ttrs = self.time_to_recover
        if not ttrs or any(t < 0 for t in ttrs):
            return -1
        return max(ttrs)

    @property
    def dip_depth(self) -> float:
        """Goodput dip depth while the schedule is active: 1 - (minimum
        binned rate inside the fault window) / baseline, in [0, 1]."""
        rates, n = self._goodput_rates()
        base = self._baseline_rate
        if not n or base <= 0 or self.first_fault < 0:
            return 0.0
        b0 = min(self.first_fault // self.goodput_bin, n - 1)
        return float(np.clip(1.0 - rates[b0:].min() / base, 0.0, 1.0))

    @property
    def dip_ticks(self) -> int:
        """Ticks (bin-quantized) from the first fault with binned goodput
        below 90% of the healthy baseline — the dip duration."""
        rates, n = self._goodput_rates()
        base = self._baseline_rate
        if not n or base <= 0 or self.first_fault < 0:
            return 0
        b0 = min(self.first_fault // self.goodput_bin, n - 1)
        return int((rates[b0:] < 0.9 * base).sum()) * self.goodput_bin

    # -- export -------------------------------------------------------------

    @property
    def point_tag(self) -> str:
        return point_tag(self.point)

    @property
    def name(self) -> str:
        """Stable row key: ``scenario/algo+lb[point]/sN``."""
        return (f"{self.scenario}/{self.algo}+{self.lb}"
                f"[{self.point_tag}]/s{self.seed}")

    def row(self) -> dict:
        """One tidy, JSON-able row for fig scripts and the bench ledger."""
        d = dict(
            name=self.name, scenario=self.scenario, algo=self.algo,
            lb=self.lb, point=dict(self.point), seed=self.seed,
            max_ticks=self.max_ticks, ticks=self.ticks,
            n_flows=self.n_flows, n_done=self.n_done,
            all_done=self.all_done, completion=self.completion,
            fct_mean=round(self.fct_mean, 3), fct_p99=round(self.fct_p99, 3),
            jain=round(self.jain, 6),
            slowdown_mean=round(self.slowdown_mean, 6),
            slowdown_p99=round(self.slowdown_p99, 6),
            trims=self.trims, drops=self.drops, blackholed=self.blackholed,
            timeouts=self.timeouts, retx=self.retx,
            spurious_frac=round(self.spurious_frac, 6),
            delivered_bytes=self.delivered_bytes,
            q_mean=round(self.q_mean, 6), q_max=self.q_max,
        )
        if self.coll_id is not None and np.any(self.coll_id >= 0):
            # collective metrics, only when the workload groups flows
            d.update(cct=self.cct, n_collectives=len(self.cct_by_coll))
        if self.first_fault >= 0:
            # recovery metrics, only for runs with an active fault schedule
            d.update(
                fault_ticks=self.fault_ticks,
                delivered_fault_frac=round(self.delivered_fault_frac, 6),
                ttr_max=self.ttr_max,
                dip_depth=round(self.dip_depth, 4),
                dip_ticks=self.dip_ticks,
            )
        if self.wall_s is not None:
            d["wall_s"] = round(self.wall_s, 6)
        return d

    def summary(self) -> dict:
        """``metrics.summarize``-shaped dict (compat helper)."""
        return dict(
            ticks=self.ticks, all_done=self.all_done, n_done=self.n_done,
            fct_ticks=self.fct, fct_max=self.completion,
            fct_min=self.fct_min, fct_mean=self.fct_mean,
            fct_p99=self.fct_p99,
            spread=(float(self.fct_done.max() - self.fct_done.min())
                    if self.n_done else -1.0),
            trims=self.trims, drops=self.drops, blackholed=self.blackholed,
            timeouts=self.timeouts, retx=self.retx, acks=self.acks,
            delivered_bytes=self.delivered_bytes,
            spurious_retx=self.spurious_retx,
            spurious_frac=self.spurious_frac, rtt_hist=self.rtt_hist,
            q_mean=self.q_mean, q_max=self.q_max,
            goodput_bytes=self.goodput, mtu=self.mtu)

    def __repr__(self) -> str:
        return (f"RunResult({self.name}: ticks={self.ticks} "
                f"done={self.n_done}/{self.n_flows} "
                f"completion={self.completion} jain={self.jain:.3f} "
                f"trims={self.trims})")


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class StudyResult:
    """The finished ``P x S`` grid: point-major lanes of RunResults."""

    scenario: str
    points: tuple             # P normalized points
    seeds: tuple              # S ints
    results: tuple            # P*S RunResults, lane = p*S + s
    states: state.SimState    # [P*S]-stacked final states (host numpy)
    wall_s: float
    cache_hits: int = 0       # lanes served from the result cache
    cache_misses: int = 0     # lanes actually computed (when caching)

    def __len__(self) -> int:
        return len(self.results)

    def __iter__(self):
        return iter(self.results)

    def __getitem__(self, lane) -> RunResult:
        return self.results[lane]

    @property
    def n_points(self) -> int:
        return len(self.points)

    @property
    def n_seeds(self) -> int:
        return len(self.seeds)

    def lane(self, point_idx: int, seed_idx: int = 0) -> RunResult:
        return self.results[point_idx * self.n_seeds + seed_idx]

    def by_point(self, point_idx: int) -> tuple:
        """All seeds of one sweep point."""
        s = self.n_seeds
        return self.results[point_idx * s:(point_idx + 1) * s]

    def rows(self) -> list:
        """Tidy rows (one per lane) for fig scripts / the bench ledger."""
        return [r.row() for r in self.results]

    def best(self, metric: str = "completion") -> RunResult:
        """Lane minimizing ``metric``.  Unfinished lanes rank *strictly*
        last regardless of their metric value (an unfinished lane's
        partial completion/FCT can look arbitrarily good — including the
        0 / -1 / NaN sentinels — and must never beat a finished lane);
        sentinel values (negative, NaN) rank last within each group, and
        exact ties resolve to the lowest lane index (stable)."""
        def key(lane_r):
            lane, r = lane_r
            v = float(getattr(r, metric))
            if not (v >= 0):          # negative sentinel or NaN
                v = np.inf
            return (not r.all_done, v, lane)
        return min(enumerate(self.results), key=key)[1]

    def __repr__(self) -> str:
        return (f"StudyResult({self.scenario}: {self.n_points} points x "
                f"{self.n_seeds} seeds, wall {self.wall_s:.2f}s)")


# --------------------------------------------------------------------------
# the Study planner
# --------------------------------------------------------------------------


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class Study:
    """A planned ``Scenario x points x seeds`` grid.  Build via
    :func:`study`; execute via :meth:`run` (typed results) or
    :meth:`run_states` (the ``[P*S]`` final states).

    As the reference's, it holds the lane-batched constants ``consts_b``
    and their axes (0: swept, one row a lane; ``None``: shared), and runs
    its lanes as one batch (``shard.run_lanes``)."""

    scenario: Scenario
    points: tuple             # P normalized ((k, v), ...) points
    seeds: tuple              # S ints
    sim: engine.Sim           # built for the base config (the tick, Dims)
    consts_b: state.Consts    # [P*S]-batched where swept, shared otherwise
    axes: state.Consts        # matching tree: 0 (swept) / None (shared)
    salts: tuple              # P*S ints, lane = p*S + s -> seeds[s]
    # the spans of planning it, recorded under torch.profiler
    # (``trace_guard.profiled``); ``run`` records on into it
    recording: Recording | None = dataclasses.field(default=None, repr=False)

    @property
    def n_points(self) -> int:
        return len(self.points)

    @property
    def n_seeds(self) -> int:
        return len(self.seeds)

    @property
    def n_lanes(self) -> int:
        return len(self.salts)

    @property
    def device(self) -> torch.device:
        return self.sim.device

    def _max_ticks(self, max_ticks) -> int:
        return int(max_ticks if max_ticks is not None
                   else self.scenario.max_ticks)

    def lane_point_seed(self, lane: int) -> tuple:
        """``(point, seed)`` of one point-major lane index."""
        return self.points[lane // self.n_seeds], self.salts[lane]

    def _consts_subset(self, lanes):
        """Batched Consts restricted to ``lanes`` (swept leaves row-gathered,
        shared leaves untouched)."""
        if len(lanes) == self.n_lanes and list(lanes) == list(range(self.n_lanes)):
            return self.consts_b
        idx = torch.as_tensor(np.asarray(lanes, np.int64), device=self.device)
        return state.tree_map(lambda x, a: x.index_select(0, idx) if a == 0 else x,
                              self.consts_b, self.axes)

    def init(self, lanes=None) -> state.SimState:
        """The tick-0 lane batch (all ``[P*S]`` lanes, or ``lanes``) on the
        device, each lane under its own constants and seed salt."""
        lanes = range(self.n_lanes) if lanes is None else lanes
        return state.init_lanes(self.sim.dims, self._consts_subset(lanes), self.axes,
                                [self.salts[i] for i in lanes])

    def _run_lane_subset(self, lanes, max_ticks: int, mesh=None) -> state.SimState:
        """Run only ``lanes`` (absolute point-major indices) as one batch and
        return their ``[len(lanes)]`` final states, copied to the host: from
        a card through one page-locked block (``state.to_host_batch``).
        Each lane's trajectory does not depend on the batch it runs in
        (per-lane gating and leaping), so the result is bit-equal to the
        same lanes of a full-grid run."""
        lanes = list(lanes)
        with span("study.init"):
            st = self.init(lanes)
        st = shard.run_lanes(self.sim, self._consts_subset(lanes), self.axes, st,
                             max_ticks, mesh=mesh)
        with span("study.host_copy") as sp:
            out = (state.to_host_batch(st) if st.now.device.type == "cuda"
                   else state.to_numpy(st))
            sp.count(bytes=sum(x.nbytes for x in state.tree_leaves(out)))
        return out

    def run_states(self, max_ticks: int | None = None, *,
                   mesh=None) -> state.SimState:
        """Run every lane to completion as one batch; their final states
        stacked on the host along a leading ``[P*S]`` axis."""
        return self._run_lane_subset(range(self.n_lanes), self._max_ticks(max_ticks),
                                     mesh=mesh)

    def lane_keys(self, max_ticks: int | None = None) -> list:
        """Content address of every lane (``cache.lane_key``) — the
        scenario digest is computed once, the code digest per process."""
        mt = self._max_ticks(max_ticks)
        sd = cache_mod.scenario_digest(self.scenario, mt)
        cd = cache_mod.code_digest()
        return [cache_mod.lane_key(sd, *self.lane_point_seed(lane),
                                   code_dig=cd)
                for lane in range(self.n_lanes)]

    def _lane_result(self, lane_st, lane: int, max_ticks: int,
                     meta: dict) -> RunResult:
        pt, seed = self.lane_point_seed(lane)
        return RunResult.from_state(
            self.sim, lane_st, scenario=self.scenario.name,
            point=pt, seed=seed, max_ticks=max_ticks, flow_meta=meta)

    def run(self, max_ticks: int | None = None, *, mesh=None,
            cache=None, chunk_lanes: int | None = None) -> StudyResult:
        """Execute the grid and pull typed per-lane results.

        ``mesh``         the devices of ``shard.lane_mesh()``: more than
                         one spreads the lanes over them, one lane loop
                         a shard (``shard.run_lanes``); with ``cache`` or
                         ``chunk_lanes``, each chunk is spread so.
        ``cache``        reuse finished lanes by content address —
                         ``True`` (default dir), a path, or a
                         :class:`cache.ResultCache`; only missing lanes
                         are computed, and every computed lane is written
                         back.  Hit/miss counts land on the result.
        ``chunk_lanes``  run missing lanes at most this many at a time,
                         flushing each finished chunk to the cache — the
                         checkpoint granularity for resumable grids.

        Every combination is bit-equal to the plain uncached run."""
        mt = self._max_ticks(max_ticks)
        rc = cache_mod.resolve(cache)
        with profiled(self.recording), span("study.run", lanes=self.n_lanes):
            _sync(self.device)
            t0 = time.perf_counter()
            if rc is None and chunk_lanes is None:
                states_h = self.run_states(mt, mesh=mesh)
                hits, misses = 0, self.n_lanes
            else:
                states_h, hits, misses = self._run_stitched(
                    mt, rc=rc, chunk_lanes=chunk_lanes, mesh=mesh)
            wall = time.perf_counter() - t0
            with span("study.results"):
                meta = _flow_meta(self.sim)
                results = [self._lane_result(state.lane(states_h, lane), lane, mt, meta)
                           for lane in range(self.n_lanes)]
        return StudyResult(scenario=self.scenario.name, points=self.points,
                           seeds=self.seeds, results=tuple(results),
                           states=states_h, wall_s=wall,
                           cache_hits=hits, cache_misses=misses)

    def _run_stitched(self, mt: int, *, rc, chunk_lanes, mesh=None):
        """Cached/chunked execution: look every lane up in the cache, run
        the misses in chunks, each chunk one batch (flushing each finished
        chunk back), and stitch hits and fresh lanes into one host-side
        ``[P*S]`` stack.  Returns ``(states_h, hits, misses)``."""
        lane_states = [None] * self.n_lanes
        keys = self.lane_keys(mt) if rc is not None else None
        if rc is not None:
            lane_struct = state.to_numpy(self.sim.init())
            for lane, key in enumerate(keys):
                hit = rc.get(key, lane_struct)
                if hit is not None:
                    lane_states[lane] = hit[0]
        missing = [i for i in range(self.n_lanes) if lane_states[i] is None]
        hits = self.n_lanes - len(missing)
        meta = _flow_meta(self.sim)
        step = int(chunk_lanes) if chunk_lanes else max(len(missing), 1)
        cd = cache_mod.code_digest() if rc is not None else None
        for lo in range(0, len(missing), step):
            chunk = missing[lo:lo + step]
            out = self._run_lane_subset(chunk, mt, mesh=mesh)
            for j, lane in enumerate(chunk):
                lane_st = state.lane(out, j)
                lane_states[lane] = lane_st
                if rc is not None:
                    res = self._lane_result(lane_st, lane, mt, meta)
                    rc.put(keys[lane], lane_st, res.row(),
                           extra=dict(code_digest=cd, name=res.name))
        return state.stack_lanes(lane_states), hits, len(missing)

    def __repr__(self) -> str:
        return (f"Study({self.scenario.name}: {self.n_points} points x "
                f"{self.n_seeds} seeds = {self.n_lanes} lanes)")


def _resolve(sc) -> Scenario:
    return scenarios.scenario(sc) if isinstance(sc, str) else sc


def study(sc, points=None, seeds=(0,), device="cuda",
          **scenario_overrides) -> Study:
    """Plan a ``Scenario x points x seeds`` grid on ``device`` (the card
    unless the caller asks for the CPU).

    ``sc`` is a :class:`Scenario` or a registered scenario name;
    ``points`` a sequence of sweep-point mappings (numeric ``SimConfig``
    fields and CC tuning kwargs — see ``CFG_KEYS`` / ``CC_PARAM_KEYS``;
    ``None`` or ``[{}]`` = just the base config); ``seeds`` the per-lane
    salt seeds.  Anything per-point that would change ``Dims`` raises at
    plan time (``KeyError``)."""
    with profiled() as rec, span("study.plan") as sp:
        plan = _plan(sc, points, seeds, device, scenario_overrides, rec)
        sp.count(lanes=plan.n_lanes)
    return plan


def _plan(sc, points, seeds, device, scenario_overrides, recording) -> Study:
    sc = _resolve(sc)
    if scenario_overrides:
        sc = sc.with_(**scenario_overrides)
    pts = (tuple(_norm_point(p) for p in points)
           if points is not None else ((),))
    if not pts:
        raise ValueError("empty sweep")
    seeds = tuple(int(s) for s in seeds)
    if not seeds:
        raise ValueError("empty seeds")
    cfgs = [apply_point(sc.cfg, dict(pt)) for pt in pts]   # keys checked first
    engine.check_lane_backends(sc.cfg)
    # engine.build -> state.derive validates the workload up front
    sim = engine.build(sc.cfg, sc.wl, device=device)
    derived = [(sc.cfg, sim.consts)]
    per_point = []
    for cfg in cfgs:
        for c, consts in derived:
            if c == cfg:
                break
        else:
            _, _, dims, consts = state.derive(cfg, sc.wl, device)
            if dims != sim.dims:
                raise ValueError(f"point {cfg} changes Dims: {dims} != {sim.dims}")
            derived.append((cfg, consts))
        per_point.append(consts)
    consts_b, axes = _stack_consts(per_point, len(seeds))
    salts = tuple(np.tile(np.asarray(seeds, np.int64), len(pts)).tolist())
    return Study(scenario=sc, points=pts, seeds=seeds, sim=sim,
                 consts_b=consts_b, axes=axes, salts=salts, recording=recording)


def run(sc, *, seed: int = 0, max_ticks: int | None = None, device="cuda",
        **scenario_overrides) -> RunResult:
    """Run one scenario standalone (``Sim.run``) on ``device`` (the card
    unless the caller asks for the CPU) -> RunResult.

    ``sc`` is a :class:`Scenario` or a registered name; ``overrides`` are
    forwarded to :meth:`Scenario.with_` (``algo=``, ``lb=``, ...).
    ``wall_s`` covers ``Sim.run`` alone, to the card's last tick."""
    sc = _resolve(sc)
    if scenario_overrides:
        sc = sc.with_(**scenario_overrides)
    mt = int(max_ticks if max_ticks is not None else sc.max_ticks)
    sim = engine.build(sc.cfg, sc.wl, device=device)   # validates the workload
    _sync(sim.device)
    t0 = time.perf_counter()
    st = sim.run(max_ticks=mt, seed=seed)
    _sync(sim.device)
    wall = time.perf_counter() - t0
    return RunResult.from_state(sim, st, scenario=sc.name,
                                seed=seed, max_ticks=mt, wall_s=wall)
