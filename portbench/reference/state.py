"""Typed simulator state, configuration, and build-time derivation.

This module owns every container the phase pipeline operates on:

  ``SimConfig``  user-facing knobs (dataclass; static + numeric mixed)
  ``Dims``       static shape/branch facts (Python ints/bools — hashable,
                 safe to close over in jitted code; changing any retraces)
  ``Consts``     *traced* numeric constants (a jax pytree — changing any
                 value, e.g. a CC parameter or the RED thresholds, reuses
                 the compiled step; ``netsim/sweep.py`` vmaps over a batch
                 of these for one-compile parameter sweeps)
  ``SimState``   the per-tick mutable world

``derive(cfg, wl)`` maps a config+workload onto (topology, timing, Dims,
Consts); ``init_state(dims, consts)`` produces the tick-0 world.  The six
tick phases in ``fabric``/``transport``/``sender``/``metrics`` are pure
functions ``(Dims, Consts, SimState) -> SimState`` composed by
``engine.build``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

from . import np32 as jnp
import numpy as np

from . import registry, reps
from .cctypes import CCParams, CCState, init_cc_state, make_cc_params
from . import faults as faults_schedule
from .metrics import Metrics, init_metrics
from .topology import build_topology
from .units import (FatTreeConfig, LinkConfig,
                                derive_timing, gamma)
from .workloads import Workload

I32 = jnp.int32
F32 = jnp.float32


# --------------------------------------------------------------------------
# configuration
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SimConfig:
    link: LinkConfig = LinkConfig()
    tree: FatTreeConfig = FatTreeConfig()
    algo: str = "smartt"
    cc_backend: str = "jnp"          # "jnp" | "pallas" (kernels/cc_update)
    fabric_backend: str = "jnp"      # "jnp" | "pallas" — enqueue-rank +
                                     # send/grant arbitration
                                     # (kernels/enqueue_arb)
    transport_backend: str = "jnp"   # "jnp" | "pallas" — sent-ring
                                     # ACK/trim/timeout drain
                                     # (kernels/ring_drain)
    lb: str = "reps"
    superstep: int = 0               # ticks fused per run-loop iteration;
                                     # 0 = auto (one base RTT), 1 = legacy
    leap: bool = True                # event-horizon time leaping: skip
                                     # quiescent ticks in closed form
                                     # (DESIGN.md Sec. 6.3; auto-disabled
                                     # for paced CC and PLB, whose state
                                     # ages on event-free ticks)
    trimming: bool = True
    rto_mult: float = 0.0            # RTO = rto_mult * trtt; 0 = auto
                                     # (3.0 with trimming, 2.0 aggressive without)
    num_entropies: int = 256
    react_every: int = 1             # CC reaction granularity (Fig. 3b)
    credit_window_mult: float = 1.0  # EQDS outstanding-credit window (BDPs)
    start_cwnd_mult: float = 1.25    # initial window as fraction of BDP
    kmin_frac: float = 0.2           # RED thresholds as fraction of port buffer
    kmax_frac: float = 0.8
    # fault injection (Fig. 7): a faults.FaultSchedule (timeline of
    # fail/degrade/repair events plus periodic flapping), or the legacy
    # static tuples ((rack, uplink, period), ...) / ((kind, i, j, period),
    # ...) which lower to one-event schedules — period 2 = half-rate link,
    # period 0 = dead link (blackholes traffic).  Schedule times are
    # relative to fault_start, which stays a sweepable scalar.
    faults: tuple = ()
    fault_start: int = 0
    rto_backoff_max: int = 0         # capped exponential RTO backoff:
                                     # RTO * 2^min(consecutive timeouts,
                                     # cap); 0 = off (legacy fixed RTO)
    evict_on_timeout: bool = False   # REPS: evict the cached entropy on
                                     # timeout so retransmits explore
                                     # fresh paths around a failure
    goodput_bin: int = 0             # recovery-metric goodput histogram
                                     # bin width (ticks); 0 = auto (8 brtt)
    cc_overrides: tuple = ()         # (("fd", 0.5), ...) applied to CCParams


# --------------------------------------------------------------------------
# static dimensions / branch selectors
# --------------------------------------------------------------------------


class Dims(NamedTuple):
    """Shape- and branch-determining facts.  All plain Python scalars:
    hashable, compared by value, safe as closed-over constants under jit."""

    N: int          # nodes
    NQ: int         # queues (output ports)
    NE: int         # emitters (queues + sender NICs)
    NF: int         # flows
    CAP: int        # per-port queue capacity (packets)
    W: int          # sent-ring slots per flow
    WW: int         # W // 32 loss-bitmap words
    L: int          # wire-latency ring length
    R: int          # control-return ring length
    MAXW: int       # receiver dedupe bitmap words
    FMAX: int       # max flows per sender
    FRMAX: int      # max flows per receiver
    P: int          # racks
    U: int          # T0 uplinks per rack (spines / aggs-per-pod)
    M: int          # nodes per rack
    QE: int         # edge-port base: queues [QE, NQ) are the t0_down ports
    tiers: int      # 2 or 3 (FatTreeConfig.tiers)
    window: int     # windowed-alltoall eligibility window
    D: int          # dependency-table width (0 = no table: the legacy
                    # t_start-only activation graph, bit-for-bit)
    mtu: int        # bytes
    brtt_inter: int  # base RTT ticks == BDP packets
    bdp_bytes: float
    superstep: int  # ticks per fused run-loop iteration (>= 1)
    leap: bool      # event-horizon time leaping enabled (and exact: the
                    # CC/LB choice mutates no state on event-free ticks)
    trimming: bool
    credit_based: bool
    paced: bool
    lb_mode: int
    FK: int         # fault transition-table columns (0 = no timeline)
    flapped: bool   # any flapping fault window in the schedule
    rto_backoff_max: int  # RTO backoff exponent cap (0 = backoff off)
    evict: bool     # REPS entropy eviction on timeout


# --------------------------------------------------------------------------
# traced constants
# --------------------------------------------------------------------------


class Consts(NamedTuple):
    """Numeric constants the compiled step closes over *as traced values*.

    Everything here may vary between runs of the same compiled step —
    that is what makes the batched config sweep one compilation.
    """

    src: jnp.ndarray             # i32 [NF]
    dst: jnp.ndarray             # i32 [NF]
    size: jnp.ndarray            # i32 [NF] flow bytes
    t_start: jnp.ndarray         # i32 [NF]
    dep_par: jnp.ndarray         # i32 [NF, D] parent flow id (NF = unused
                                 #   slot; D = 0 without a dependency table)
    dep_thr: jnp.ndarray         # i32 [NF, D] parent bytes that must have
                                 #   landed before this flow activates
    ret: jnp.ndarray             # i32 scalar ACK/grant return latency (the
                                 #   ack ring layout requires it constant)
    flows_of: jnp.ndarray        # i32 [N, FMAX] per-sender flow table
    slot_of: jnp.ndarray         # i32 [NF] flow's column in flows_of[src]
    flows_by_recv: jnp.ndarray   # i32 [N, FRMAX]
    lat_q: jnp.ndarray           # i32 [NE] post-departure wire latency
    # -- compiled fault schedule (faults.compile_tables; times relative to
    #    fault_start so the legacy knob stays a sweepable scalar) --
    ft_time: jnp.ndarray         # i32 [NQ, max(FK, 1)] transition times
    ft_period: jnp.ndarray       # i32 [NQ, max(FK, 1)] service periods
    fl_start: jnp.ndarray        # i32 [NQ] flap window start
    fl_end: jnp.ndarray          # i32 [NQ] flap window end (INF = open)
    fl_cycle: jnp.ndarray        # i32 [NQ] flap cycle length (0 = none)
    fl_up: jnp.ndarray           # i32 [NQ] healthy ticks per cycle
    fl_period: jnp.ndarray       # i32 [NQ] period while flapped down
    fault_start: jnp.ndarray     # i32 scalar
    goodput_bin: jnp.ndarray     # i32 scalar goodput histogram bin width
    trim_delay: jnp.ndarray      # i32 scalar
    kmin: jnp.ndarray            # f32 scalar RED lower threshold (packets)
    kspan: jnp.ndarray           # f32 scalar RED kmax - kmin
    rto: jnp.ndarray             # f32 [NF]
    credit_window: jnp.ndarray   # f32 scalar (EQDS)
    start_cwnd: jnp.ndarray      # f32 scalar initial cwnd bytes
    cc: CCParams
    lb: reps.LBParams
    # -- per-tick invariants hoisted out of the phase bodies (the phases
    #    would otherwise re-materialize these iotas/gathers every tick) --
    qidx: jnp.ndarray            # i32 [NQ] port iota
    eidx: jnp.ndarray            # i32 [NE] emitter iota
    flow_ids: jnp.ndarray        # i32 [NF] flow iota
    node_ids: jnp.ndarray        # i32 [N] node iota
    # -- table-driven routing (topology.build_topology; fabric.route_switch
    #    gathers through these — tier-generic, no dense tables) --
    nbr_q: jnp.ndarray           # i32 [NQ] switch each port's wire feeds
                                 #   (edge rows clamped to 0; edge_q gates)
    edge_q: jnp.ndarray          # bool [NQ] port delivers to a host NIC
    sw_lo: jnp.ndarray           # i32 [NSW] switch subtree interval [lo, hi)
    sw_hi: jnp.ndarray           # i32 [NSW]
    sw_up_base: jnp.ndarray      # i32 [NSW] first equal-cost up port
    sw_up_cnt: jnp.ndarray       # i32 [NSW] up-port count (0 at top tier)
    sw_salt: jnp.ndarray         # u32 [NSW] per-switch ECMP hash salt
    dn_base: jnp.ndarray         # i32 [NSW] down port = dn_base + d // dn_stride
    dn_stride: jnp.ndarray       # i32 [NSW] nodes covered per down port
    sw_of_q: jnp.ndarray         # i32 [NQ] switch owning each queue
    # -- per-queue routing tables: the switch tables above, pre-gathered
    #    through ``nbr_q`` at derive time so ``fabric.route_from_queue``
    #    (the departures hot path) reads [NQ] vectors directly instead of
    #    issuing seven [NSW] -> [NQ] gathers per tick --
    q_lo: jnp.ndarray            # i32 [NQ] = sw_lo[nbr_q]
    q_hi: jnp.ndarray            # i32 [NQ] = sw_hi[nbr_q]
    q_up_base: jnp.ndarray       # i32 [NQ] = sw_up_base[nbr_q]
    q_up_cnt: jnp.ndarray        # i32 [NQ] = sw_up_cnt[nbr_q]
    q_salt: jnp.ndarray          # u32 [NQ] = sw_salt[nbr_q]
    q_dn_base: jnp.ndarray       # i32 [NQ] = dn_base[nbr_q]
    q_dn_stride: jnp.ndarray     # i32 [NQ] = dn_stride[nbr_q]
    # -- per-flow first-hop tables: a fresh packet's routing decision at
    #    the sender's rack switch is static per flow except for the ECMP
    #    entropy hash, so ``fabric.route_from_sender`` reduces to a select
    #    between a precomputed down queue and a hashed up port — zero
    #    gathers in the sends hot path --
    f_down: jnp.ndarray          # bool [NF] dst inside the sender's rack
    f_dn_q: jnp.ndarray          # i32 [NF] the (static) same-rack edge queue
    f_up_base: jnp.ndarray       # i32 [NF] rack switch's first up port
    f_up_cnt: jnp.ndarray        # i32 [NF] rack switch's up-port count
    f_salt: jnp.ndarray          # u32 [NF] rack switch's ECMP salt
    # -- compact enqueue emitters + per-switch fan-in groups (enqueue
    #    ranking and per-queue accept counts, kernels/enqueue_arb) --
    enq_ids: jnp.ndarray         # i32 [EQ] enqueue-capable emitter ids
    in_tbl: jnp.ndarray          # i32 [NSW, DMAX] compact emitter indices
                                 #   feeding each switch, ascending, pad EQ
    in_pos: jnp.ndarray          # i32 [EQ] compact emitter's flat slot in
                                 #   in_tbl
    lat_core: jnp.ndarray        # i32 scalar switch-facing-port wire latency
    lat_edge: jnp.ndarray        # i32 scalar t0_down wire latency
    lat_send: jnp.ndarray        # i32 scalar sender-NIC wire latency
    # -- next-event horizon invariants (DESIGN.md Sec. 6.3): slot iotas of
    #    the wire and control rings, hoisted for the leap reductions --
    iota_l: jnp.ndarray          # i32 [L] wire-ring slot iota
    iota_r: jnp.ndarray          # i32 [R] control-ring slot iota


def pkt_size(dims: Dims, consts: Consts, flow, seq):
    """True wire size of packet `seq` of `flow` (last packet may be short)."""
    rem = consts.size[jnp.clip(flow, 0, dims.NF - 1)] - seq * dims.mtu
    return jnp.clip(rem, 0, dims.mtu)


# --------------------------------------------------------------------------
# state
# --------------------------------------------------------------------------


class SimState(NamedTuple):
    now: jnp.ndarray                 # i32 scalar
    salt: jnp.ndarray                # i32 scalar — per-run hash decorrelation
    q_fields: jnp.ndarray            # i32 [NQ+1, CAP, 5] flow/seq/ent/ecn/ts
    q_head: jnp.ndarray              # i32 [NQ+1]
    q_size: jnp.ndarray              # i32 [NQ+1]
    infl: jnp.ndarray                # i32 [L, NE, 7] valid/dstq/flow/seq/ent/ecn/ts
    ack_ring: jnp.ndarray            # i32 [R, N, 6] valid/flow/seq/ecn/ent/ts
                                     #   (slot (t+ret)%R written whole per tick:
                                     #   ret is receiver-constant, so the write
                                     #   is a dynamic-update-slice, not scatter)
    trim_ring: jnp.ndarray           # i32 [R, NF+1, 2+WW] cnt/bytes/loss-bitmap
                                     #   (packed: one scatter per tick feeds the
                                     #   delayed trim count, bytes, and per-slot
                                     #   loss words; bytes are exact in i32)
    credit_ring: jnp.ndarray         # f32 [R, NF+1]
    sent: jnp.ndarray                # i32 [3, NF+1, W] component-major sent ring:
                                     #   [0]=state (0=free 1=outstanding 3=lost)
                                     #   [1]=seq  [2]=send tick
    next_seq: jnp.ndarray            # i32 [NF]
    unacked: jnp.ndarray             # f32 [NF] in-flight bytes (phase 3 -> 5)
    done: jnp.ndarray                # bool [NF]
    fct: jnp.ndarray                 # i32 [NF] (-1 = unfinished)
    goodput: jnp.ndarray             # i32 [NF] unique bytes delivered
    bitmap: jnp.ndarray              # i32 [NF+1, MAXW] receiver dedupe
    granted: jnp.ndarray             # f32 [NF] EQDS credit issued
    trim_seen: jnp.ndarray           # f32 [NF+1] trimmed bytes observed by the
                                     #   receiver (row NF is scatter write-off;
                                     #   only maintained for credit-based algos)
    rr_recv: jnp.ndarray             # i32 [N]
    rr_send: jnp.ndarray             # i32 [N]
    pace_accum: jnp.ndarray          # f32 [NF]
    rto_backoff: jnp.ndarray         # i32 [NF] consecutive-timeout count
                                     #   (drives capped exponential RTO
                                     #   backoff; 0 unless Dims enables it)
    cc: CCState
    lb: reps.LBState
    m: Metrics


# --------------------------------------------------------------------------
# derivation
# --------------------------------------------------------------------------


def derive(cfg: SimConfig, wl: Workload):
    """Map (config, workload) -> (Topology, Timing, Dims, Consts)."""
    link, tree = cfg.link, cfg.tree
    topo = build_topology(tree)
    tm = derive_timing(link, tree)

    N, NQ, NE = tree.n_nodes, topo.n_queues, topo.n_emitters
    NF = wl.n_flows
    wl.validate(n_nodes=N)   # reject bad tables before any shape math
    MTU = float(link.mtu_bytes)
    CAP = int(tm.brtt_inter)                      # 1 BDP per port queue
    max_pkts = int(np.ceil(wl.size.max() / MTU))
    # sent-ring slots: 1.5x the max window in packets (seq-range headroom;
    # new sends block on occupied slots, modeling a bounded retx buffer) —
    # but never wider than the workload's own seq space: once W >= max_pkts
    # the slot map seq % W is injective for every flow, so any larger ring
    # is trajectory-identical dead weight, and all the [NF, W] transport
    # passes (ring drain, timeout scans, emission writes) pay for it.
    W = int(2 ** np.ceil(np.log2(max(1.5 * 1.25 * tm.brtt_inter, 32))))
    W = min(W, int(2 ** np.ceil(np.log2(max(max_pkts, 32)))))
    WW = W // 32
    L = tm.hop + 2
    R = int(max(tm.ret_inter, tm.trim_delay) + tm.hop + 4)
    MAXW = (max_pkts + 31) // 32
    P, U, M = tree.racks, tree.uplinks, tree.nodes_per_rack
    QE = NQ - N                                   # edge-port block base

    # ---- per-flow constants ----
    # ACK return delay is *globally constant*: the ack ring is indexed
    # (arrival_tick + ret, receiver) and a receiver delivers one packet per
    # tick, so slot (t + ret) % R belongs exclusively to the deliveries of
    # tick t — which lets `fabric.arrivals` write the whole [N]-row slot as
    # one dynamic-update-slice instead of a scatter.
    # Per-flow base RTT: hop-count-specific forward latency (same rack /
    # cross-rack within a pod, which IS the longest path on two-tier trees
    # / cross-core) plus the constant ACK return delay.
    sr, dr = wl.src // M, wl.dst // M
    Pg = tree.racks_per_pod
    fwd_f = np.where(sr == dr, tm.fwd_intra,
                     np.where(sr // Pg == dr // Pg, tm.fwd_pod,
                              tm.fwd_inter))
    brtt_f = (fwd_f + tm.ret_inter).astype(np.float32)
    ret_f = jnp.asarray(tm.ret_inter, I32)

    bdp = float(tm.brtt_inter * MTU)
    cc_kwargs = dict(cfg.cc_overrides)
    cc_params = make_cc_params(
        mtu=MTU, bdp=bdp, brtt=brtt_f,
        react_every=cfg.react_every,
        gamma=gamma(link, tm),
        use_trimming=cfg.trimming,
        **cc_kwargs,
    )
    lb_params = reps.make_lb_params(
        num_entropies=cfg.num_entropies,
        bdp_pkts=int(tm.brtt_inter),
    )
    rto_mult = cfg.rto_mult or (3.0 if cfg.trimming else 2.0)
    rto_f = jnp.asarray(rto_mult, F32) * cc_params.trtt
    credit_window = jnp.asarray(cfg.credit_window_mult * bdp, F32)

    # ---- per-sender / per-receiver flow matrices ----
    FMAX = max(int(np.max(np.bincount(wl.src, minlength=N))), 1)
    FRMAX = max(int(np.max(np.bincount(wl.dst, minlength=N))), 1)
    flows_of = np.full((N, FMAX), NF, np.int32)
    slot_of = np.zeros(NF, np.int32)               # inverse of flows_of
    cnt = np.zeros(N, np.int64)
    for f in np.argsort(wl.order, kind="stable"):  # per-sender, ordered
        s = wl.src[f]
        flows_of[s, cnt[s]] = f
        slot_of[f] = cnt[s]
        cnt[s] += 1
    flows_by_recv = np.full((N, FRMAX), NF, np.int32)
    cnt = np.zeros(N, np.int64)
    for f in range(NF):
        r = wl.dst[f]
        flows_by_recv[r, cnt[r]] = f
        cnt[r] += 1
    window = int(min(wl.window, FMAX))

    # ---- dependency table (collectives, DESIGN.md Sec. 11) ----
    # Dense [NF, D] parent ids + byte thresholds; the workload's -1 free
    # slots normalize to the NF sentinel (same write-off convention as
    # flows_of).  D == 0 keeps sender.activated on the legacy t_start-only
    # path — structurally the same traced graph as before the table existed.
    D = wl.n_deps
    if D:
        dep_par = np.asarray(wl.dep_par, np.int64).copy()
        dep_par[dep_par < 0] = NF
        dep_thr = np.asarray(wl.dep_thr, np.int64).copy()
        dep_thr[dep_par == NF] = 0          # free slots trivially satisfied
    else:
        dep_par = np.zeros((NF, 0), np.int64)
        dep_thr = np.zeros((NF, 0), np.int64)

    # ---- per-emitter wire latency ----
    # fabric.departures / sender.sends rely on the latency being uniform
    # within each of the three contiguous emitter classes (switch-facing
    # ports at any tier, edge ports, sender NICs) and strictly below the
    # ring length L.
    lat_q = np.zeros(NE, np.int32)
    lat_q[:QE] = link.link_lat_ticks + link.switch_lat_ticks
    lat_q[QE:NQ] = link.link_lat_ticks
    lat_q[NQ:] = 1 + link.link_lat_ticks + link.switch_lat_ticks
    for cls in (lat_q[:QE], lat_q[QE:NQ], lat_q[NQ:]):
        if not (np.all(cls == cls[0]) and 0 < cls[0] < L):
            raise ValueError(
                f"wire latency must be uniform within each emitter class "
                f"(switch-facing/edge/sender) and satisfy 0 < lat < L={L}; "
                f"got {sorted(set(lat_q.tolist()))}")

    # ---- fault schedule compilation (faults.py) ----
    # Legacy static tuples lower to one-event schedules; a FaultSchedule
    # passes through.  compile_tables validates every entry (kind, ranges,
    # signs) with actionable errors naming the offending tuple, and emits
    # the per-port transition tables the fabric evaluates each tick.
    sched = faults_schedule.lower(cfg.faults)
    cf = faults_schedule.compile_tables(sched, topo, cfg.fault_start)
    if cfg.rto_backoff_max < 0:
        raise ValueError(
            f"rto_backoff_max must be >= 0, got {cfg.rto_backoff_max}")
    if cfg.goodput_bin < 0:
        raise ValueError(f"goodput_bin must be >= 0, got {cfg.goodput_bin}")
    goodput_bin = int(cfg.goodput_bin) or 8 * int(tm.brtt_inter)
    if not cfg.kmax_frac > cfg.kmin_frac:
        raise ValueError(
            f"RED thresholds need kmax_frac > kmin_frac, got "
            f"{cfg.kmin_frac} .. {cfg.kmax_frac}")
    kmin = cfg.kmin_frac * CAP
    kmax = cfg.kmax_frac * CAP

    if cfg.superstep < 0:
        raise ValueError(f"superstep must be >= 0, got {cfg.superstep}")
    superstep = int(cfg.superstep) or int(tm.brtt_inter)

    # ---- pre-gathered routing tables (per-tick gather hoisting) ----
    # Per-queue: the seven switch tables route_from_queue needs, indexed
    # through nbr_q once here instead of every tick (edge rows clamp to
    # switch 0 exactly like nbr_q itself; edge_q gates them off).
    # Per-flow: a fresh packet's first hop is decided at the sender's rack
    # switch sw_f = src // M; the subtree test and the down queue are
    # workload constants, only the up-port ECMP hash needs the entropy.
    nbr = np.maximum(np.asarray(topo.nbr_sw[:NQ]), 0)
    sw_f = np.asarray(wl.src, np.int64) // M
    f_lo = np.asarray(topo.sw_lo)[sw_f]
    f_hi = np.asarray(topo.sw_hi)[sw_f]
    f_down = (wl.dst >= f_lo) & (wl.dst < f_hi)
    f_dn_q = (np.asarray(topo.dn_base)[sw_f]
              + np.asarray(wl.dst) // np.asarray(topo.dn_stride)[sw_f])

    # Event-horizon time leaping (DESIGN.md Sec. 6.3) is only exact when an
    # event-free tick is a state no-op.  Rate pacing accrues a budget every
    # tick and PLB rolls its round clock on wall time, so those two
    # configurations run leap-free regardless of the knob.
    paced = cfg.algo in registry.PACED
    leap = bool(cfg.leap) and not paced and cfg.lb != "plb"

    dims = Dims(
        N=N, NQ=NQ, NE=NE, NF=NF, CAP=CAP, W=W, WW=WW, L=L, R=R,
        MAXW=MAXW, FMAX=FMAX, FRMAX=FRMAX, P=P, U=U, M=M, QE=QE,
        tiers=tree.tiers,
        window=window, D=D, mtu=int(MTU), brtt_inter=int(tm.brtt_inter),
        bdp_bytes=bdp, superstep=superstep, leap=leap,
        trimming=cfg.trimming,
        credit_based=cfg.algo in registry.CREDIT_BASED,
        paced=paced,
        lb_mode=reps.LB_NAMES[cfg.lb],
        FK=cf.FK, flapped=cf.flapped,
        rto_backoff_max=int(cfg.rto_backoff_max),
        evict=bool(cfg.evict_on_timeout),
    )
    consts = Consts(
        src=jnp.asarray(wl.src, I32),
        dst=jnp.asarray(wl.dst, I32),
        size=jnp.asarray(wl.size, I32),
        t_start=jnp.asarray(wl.t_start, I32),
        dep_par=jnp.asarray(dep_par, I32),
        dep_thr=jnp.asarray(dep_thr, I32),
        ret=ret_f,
        flows_of=jnp.asarray(flows_of),
        slot_of=jnp.asarray(slot_of),
        flows_by_recv=jnp.asarray(flows_by_recv),
        lat_q=jnp.asarray(lat_q),
        ft_time=jnp.asarray(cf.ft_time),
        ft_period=jnp.asarray(cf.ft_period),
        fl_start=jnp.asarray(cf.fl_start),
        fl_end=jnp.asarray(cf.fl_end),
        fl_cycle=jnp.asarray(cf.fl_cycle),
        fl_up=jnp.asarray(cf.fl_up),
        fl_period=jnp.asarray(cf.fl_period),
        fault_start=jnp.asarray(cfg.fault_start, I32),
        goodput_bin=jnp.asarray(goodput_bin, I32),
        trim_delay=jnp.asarray(tm.trim_delay, I32),
        kmin=jnp.asarray(kmin, F32),
        kspan=jnp.asarray(kmax - kmin, F32),
        rto=rto_f,
        credit_window=credit_window,
        start_cwnd=jnp.asarray(cfg.start_cwnd_mult * bdp, F32),
        cc=cc_params,
        lb=lb_params,
        qidx=jnp.arange(NQ, dtype=I32),
        eidx=jnp.arange(NE, dtype=I32),
        flow_ids=jnp.arange(NF, dtype=I32),
        node_ids=jnp.arange(N, dtype=I32),
        nbr_q=jnp.asarray(np.maximum(topo.nbr_sw[:NQ], 0), I32),
        edge_q=jnp.asarray(topo.nbr_sw[:NQ] < 0),
        sw_lo=jnp.asarray(topo.sw_lo, I32),
        sw_hi=jnp.asarray(topo.sw_hi, I32),
        sw_up_base=jnp.asarray(topo.sw_up_base, I32),
        sw_up_cnt=jnp.asarray(topo.sw_up_cnt, I32),
        sw_salt=jnp.asarray(topo.sw_salt, jnp.uint32),
        dn_base=jnp.asarray(topo.dn_base, I32),
        dn_stride=jnp.asarray(topo.dn_stride, I32),
        sw_of_q=jnp.asarray(topo.sw_of_q, I32),
        q_lo=jnp.asarray(np.asarray(topo.sw_lo)[nbr], I32),
        q_hi=jnp.asarray(np.asarray(topo.sw_hi)[nbr], I32),
        q_up_base=jnp.asarray(np.asarray(topo.sw_up_base)[nbr], I32),
        q_up_cnt=jnp.asarray(np.asarray(topo.sw_up_cnt)[nbr], I32),
        q_salt=jnp.asarray(np.asarray(topo.sw_salt)[nbr], jnp.uint32),
        q_dn_base=jnp.asarray(np.asarray(topo.dn_base)[nbr], I32),
        q_dn_stride=jnp.asarray(np.asarray(topo.dn_stride)[nbr], I32),
        f_down=jnp.asarray(f_down),
        f_dn_q=jnp.asarray(f_dn_q, I32),
        f_up_base=jnp.asarray(np.asarray(topo.sw_up_base)[sw_f], I32),
        f_up_cnt=jnp.asarray(np.asarray(topo.sw_up_cnt)[sw_f], I32),
        f_salt=jnp.asarray(np.asarray(topo.sw_salt)[sw_f], jnp.uint32),
        enq_ids=jnp.asarray(topo.enq_ids, I32),
        in_tbl=jnp.asarray(topo.in_tbl, I32),
        in_pos=jnp.asarray(topo.in_pos, I32),
        lat_core=jnp.asarray(lat_q[0], I32),
        lat_edge=jnp.asarray(lat_q[QE], I32),
        lat_send=jnp.asarray(lat_q[NQ], I32),
        iota_l=jnp.arange(L, dtype=I32),
        iota_r=jnp.arange(R, dtype=I32),
    )
    return topo, tm, dims, consts


# Counted each time ``init_state`` runs (eagerly or as a trace).
# ``tests/test_engine_leap.py`` asserts ``Sim.run_batch`` builds exactly one
# init state and broadcasts it, rather than re-deriving it per seed:
# ``with trace_guard("state.init", expect=1): ...`` (repro.analysis).

# Sentinel "no event in sight" horizon (i32-safe; run loops clamp it to the
# remaining tick budget before applying a leap).
HORIZON_INF = 1 << 30


def init_state(dims: Dims, consts: Consts) -> SimState:
    """Tick-0 world.  Pure in (dims, consts); safe under jit and vmap."""
    zeros = jnp.zeros
    NF, N, NQ = dims.NF, dims.N, dims.NQ
    cc = init_cc_state(NF, consts.cc, start_cwnd=consts.start_cwnd)
    lb = reps.init_lb_state(NF, consts.lb)
    return SimState(
        now=zeros((), I32),
        salt=zeros((), I32),
        q_fields=zeros((NQ + 1, dims.CAP, 5), I32),
        q_head=zeros((NQ + 1,), I32),
        q_size=zeros((NQ + 1,), I32),
        infl=zeros((dims.L, dims.NE, 7), I32),
        ack_ring=zeros((dims.R, N, 6), I32),
        trim_ring=zeros((dims.R, NF + 1, 2 + dims.WW), I32),
        credit_ring=zeros((dims.R, NF + 1), F32),
        sent=zeros((3, NF + 1, dims.W), I32),
        next_seq=zeros((NF,), I32),
        unacked=zeros((NF,), F32),
        done=zeros((NF,), bool),
        fct=jnp.full((NF,), -1, I32),
        goodput=zeros((NF,), I32),
        bitmap=zeros((NF + 1, dims.MAXW), I32),
        granted=zeros((NF,), F32),
        trim_seen=zeros((NF + 1,), F32),
        rr_recv=zeros((N,), I32),
        rr_send=zeros((N,), I32),
        pace_accum=zeros((NF,), F32),
        rto_backoff=zeros((NF,), I32),
        cc=cc, lb=lb, m=init_metrics(),
    )
