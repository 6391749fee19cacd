"""Typed simulator state, configuration, and build-time derivation.

This module owns every container the phase pipeline operates on:

  ``SimConfig``  user-facing knobs (dataclass; static + numeric mixed)
  ``Dims``       static shape/branch facts (Python ints/bools)
  ``Consts``     numeric constants, as tensors on the run's device
  ``SimState``   the per-tick mutable world

The containers, their leaves, the leaf order and the dtypes are the
reference's (``repro/netsim/state.py``), so a state converts leaf by leaf
(:func:`from_numpy` / :func:`to_numpy`).  The one exception: the uint32
ECMP salts (``sw_salt``, ``q_salt``, ``f_salt``) are int64 tensors holding
the same values, because PyTorch cannot shift uint32 on the CPU
(``hashing.py``).

``derive(cfg, wl, device)`` maps a config+workload onto (topology, timing,
Dims, Consts); ``init_state(dims, consts)`` produces the tick-0 world, and
``init_lanes`` the tick-0 world of a lane batch (a study's lanes, or one
run as one lane): every state leaf with a leading ``[L]`` axis.  A lane
batch's constants are the reference's ``consts_b`` and ``axes`` (a leaf
swept by a study carries a leading ``[L]`` axis, axis 0; a shared one
none), read by the tick in the two forms of :class:`LaneConsts`.  The six
tick phases in ``fabric``/``transport``/``sender``/``metrics`` are
functions ``(Dims, LaneConsts, SimState, Tick) -> SimState`` on a lane
batch, composed by ``engine.build``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.analysis.trace_guard import counter as _counter
from repro_torch.core import registry, reps
from repro_torch.core.types import (CCParams, CCState, init_cc_state,
                                    make_cc_params)
from repro_torch.netsim import faults as faults_schedule
from repro_torch.netsim.metrics import Metrics, init_metrics
from repro_torch.netsim.topology import build_topology
from repro_torch.netsim.units import (FatTreeConfig, LinkConfig,
                                      derive_timing, gamma)
from repro_torch.netsim.workloads import Workload

I32 = torch.int32
F32 = torch.float32


def resolve_device(device) -> torch.device:
    """The run's device: ``"cuda"`` unless the caller asks for the CPU.
    A CUDA request on a machine without a CUDA device is an error — the
    port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain versions on the CPU")
    return dev


# --------------------------------------------------------------------------
# configuration
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SimConfig:
    link: LinkConfig = LinkConfig()
    tree: FatTreeConfig = FatTreeConfig()
    algo: str = "smartt"
    cc_backend: str = "kernel"       # "kernel" | "plain" (kernels/cc_update)
    departures_backend: str = "kernel"  # "kernel" | "plain" — the
                                     # departures phase: one fused launch
                                     # (kernels/departures, the RED flip
                                     # inside it) or its plain version
    fabric_backend: str = "kernel"   # "kernel" | "plain" | "split" — the
                                     # arrivals phase: one fused launch
                                     # (kernels/arrivals), its plain
                                     # version, or the enqueue_rank kernel
                                     # with PyTorch glue
    sender_backend: str = "kernel"   # "kernel" | "plain" | "split" — the
                                     # sends phase: one fused launch
                                     # (kernels/sends), its plain version,
                                     # or the rr_pick kernel with PyTorch
                                     # glue; and the EQDS grants' pick:
                                     # the rr_pick kernel but under "plain"
    transport_backend: str = "kernel"  # "kernel" | "plain" | "split" —
                                     # the control phase: one fused launch
                                     # (kernels/control), its plain
                                     # version, or the ring_drain and
                                     # cc_update kernels with PyTorch glue
    lb: str = "reps"
    superstep: int = 0               # ticks run per superstep;
                                     # 0 = auto (one base RTT), 1 = legacy
    leap: bool = True                # event-horizon time leaping: skip
                                     # quiescent ticks in closed form
                                     # (DESIGN.md Sec. 6.3; auto-disabled
                                     # for paced CC and PLB)
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
    # static tuples ((kind, i, j, period), ...) which lower to one-event
    # schedules — period 2 = half-rate link, period 0 = dead link
    # (blackholes traffic).  Schedule times are relative to fault_start.
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
    """Shape- and branch-determining facts.  All plain Python scalars."""

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
    D: int          # dependency-table width (0 = no table)
    mtu: int        # bytes
    brtt_inter: int  # base RTT ticks == BDP packets
    bdp_bytes: float
    superstep: int  # ticks per superstep (>= 1)
    leap: bool      # event-horizon time leaping enabled
    trimming: bool
    credit_based: bool
    paced: bool
    lb_mode: int
    FK: int         # fault transition-table columns (0 = no timeline)
    flapped: bool   # any flapping fault window in the schedule
    rto_backoff_max: int  # RTO backoff exponent cap (0 = backoff off)
    evict: bool     # REPS entropy eviction on timeout


# --------------------------------------------------------------------------
# constants (tensors on the run's device)
# --------------------------------------------------------------------------


class Consts(NamedTuple):
    """Numeric constants of a run, leaf for leaf the reference's."""

    src: torch.Tensor             # i32 [NF]
    dst: torch.Tensor             # i32 [NF]
    size: torch.Tensor            # i32 [NF] flow bytes
    t_start: torch.Tensor         # i32 [NF]
    dep_par: torch.Tensor         # i32 [NF, D] parent flow id (NF = unused)
    dep_thr: torch.Tensor         # i32 [NF, D] parent bytes before activation
    ret: torch.Tensor             # i32 scalar ACK/grant return latency
    flows_of: torch.Tensor        # i32 [N, FMAX] per-sender flow table
    slot_of: torch.Tensor         # i32 [NF] flow's column in flows_of[src]
    flows_by_recv: torch.Tensor   # i32 [N, FRMAX]
    lat_q: torch.Tensor           # i32 [NE] post-departure wire latency
    # -- compiled fault schedule (faults.compile_tables) --
    ft_time: torch.Tensor         # i32 [NQ, max(FK, 1)] transition times
    ft_period: torch.Tensor       # i32 [NQ, max(FK, 1)] service periods
    fl_start: torch.Tensor        # i32 [NQ] flap window start
    fl_end: torch.Tensor          # i32 [NQ] flap window end (INF = open)
    fl_cycle: torch.Tensor        # i32 [NQ] flap cycle length (0 = none)
    fl_up: torch.Tensor           # i32 [NQ] healthy ticks per cycle
    fl_period: torch.Tensor       # i32 [NQ] period while flapped down
    fault_start: torch.Tensor     # i32 scalar
    goodput_bin: torch.Tensor     # i32 scalar goodput histogram bin width
    trim_delay: torch.Tensor      # i32 scalar
    kmin: torch.Tensor            # f32 scalar RED lower threshold (packets)
    kspan: torch.Tensor           # f32 scalar RED kmax - kmin
    rto: torch.Tensor             # f32 [NF]
    credit_window: torch.Tensor   # f32 scalar (EQDS)
    start_cwnd: torch.Tensor      # f32 scalar initial cwnd bytes
    cc: CCParams
    lb: reps.LBParams
    # -- per-tick invariants hoisted out of the phase bodies --
    qidx: torch.Tensor            # i32 [NQ] port iota
    eidx: torch.Tensor            # i32 [NE] emitter iota
    flow_ids: torch.Tensor        # i32 [NF] flow iota
    node_ids: torch.Tensor        # i32 [N] node iota
    # -- table-driven routing (topology.build_topology) --
    nbr_q: torch.Tensor           # i32 [NQ] switch each port's wire feeds
    edge_q: torch.Tensor          # bool [NQ] port delivers to a host NIC
    sw_lo: torch.Tensor           # i32 [NSW] switch subtree interval [lo, hi)
    sw_hi: torch.Tensor           # i32 [NSW]
    sw_up_base: torch.Tensor      # i32 [NSW] first equal-cost up port
    sw_up_cnt: torch.Tensor       # i32 [NSW] up-port count (0 at top tier)
    sw_salt: torch.Tensor         # i64 [NSW] per-switch ECMP salt (uint32 value)
    dn_base: torch.Tensor         # i32 [NSW] down port = dn_base + d // dn_stride
    dn_stride: torch.Tensor       # i32 [NSW] nodes covered per down port
    sw_of_q: torch.Tensor         # i32 [NQ] switch owning each queue
    # -- per-queue routing tables, pre-gathered through nbr_q --
    q_lo: torch.Tensor            # i32 [NQ] = sw_lo[nbr_q]
    q_hi: torch.Tensor            # i32 [NQ] = sw_hi[nbr_q]
    q_up_base: torch.Tensor       # i32 [NQ] = sw_up_base[nbr_q]
    q_up_cnt: torch.Tensor        # i32 [NQ] = sw_up_cnt[nbr_q]
    q_salt: torch.Tensor          # i64 [NQ] = sw_salt[nbr_q]
    q_dn_base: torch.Tensor       # i32 [NQ] = dn_base[nbr_q]
    q_dn_stride: torch.Tensor     # i32 [NQ] = dn_stride[nbr_q]
    # -- per-flow first-hop tables --
    f_down: torch.Tensor          # bool [NF] dst inside the sender's rack
    f_dn_q: torch.Tensor          # i32 [NF] the (static) same-rack edge queue
    f_up_base: torch.Tensor       # i32 [NF] rack switch's first up port
    f_up_cnt: torch.Tensor        # i32 [NF] rack switch's up-port count
    f_salt: torch.Tensor          # i64 [NF] rack switch's ECMP salt
    # -- compact enqueue emitters + per-switch fan-in groups --
    enq_ids: torch.Tensor         # i32 [EQ] enqueue-capable emitter ids
    in_tbl: torch.Tensor          # i32 [NSW, DMAX] compact emitter indices
    in_pos: torch.Tensor          # i32 [EQ] flat slot in in_tbl
    lat_core: torch.Tensor        # i32 scalar switch-facing-port wire latency
    lat_edge: torch.Tensor        # i32 scalar t0_down wire latency
    lat_send: torch.Tensor        # i32 scalar sender-NIC wire latency
    # -- next-event horizon invariants (DESIGN.md Sec. 6.3) --
    iota_l: torch.Tensor          # i32 [L] wire-ring slot iota
    iota_r: torch.Tensor          # i32 [R] control-ring slot iota


def pkt_size(dims: Dims, consts: Consts, flow, seq):
    """True wire size of packet `seq` of `flow` (last packet may be short)."""
    rem = consts.size[flow.clamp(0, dims.NF - 1)] - seq * dims.mtu
    return rem.clamp(0, dims.mtu)


# --------------------------------------------------------------------------
# state
# --------------------------------------------------------------------------


class SimState(NamedTuple):
    now: torch.Tensor                 # i32 scalar
    salt: torch.Tensor                # i32 scalar — per-run hash decorrelation
    q_fields: torch.Tensor            # i32 [NQ+1, CAP, 5] flow/seq/ent/ecn/ts
    q_head: torch.Tensor              # i32 [NQ+1]
    q_size: torch.Tensor              # i32 [NQ+1]
    infl: torch.Tensor                # i32 [L, NE, 7] valid/dstq/flow/seq/ent/ecn/ts
    ack_ring: torch.Tensor            # i32 [R, N, 6] valid/flow/seq/ecn/ent/ts
    trim_ring: torch.Tensor           # i32 [R, NF+1, 2+WW] cnt/bytes/loss-bitmap
    credit_ring: torch.Tensor         # f32 [R, NF+1]
    sent: torch.Tensor                # i32 [3, NF+1, W] state/seq/send tick
    next_seq: torch.Tensor            # i32 [NF]
    unacked: torch.Tensor             # f32 [NF] in-flight bytes (phase 3 -> 5)
    done: torch.Tensor                # bool [NF]
    fct: torch.Tensor                 # i32 [NF] (-1 = unfinished)
    goodput: torch.Tensor             # i32 [NF] unique bytes delivered
    bitmap: torch.Tensor              # i32 [NF+1, MAXW] receiver dedupe
    granted: torch.Tensor             # f32 [NF] EQDS credit issued
    trim_seen: torch.Tensor           # f32 [NF+1] trimmed bytes seen by receiver
    rr_recv: torch.Tensor             # i32 [N]
    rr_send: torch.Tensor             # i32 [N]
    pace_accum: torch.Tensor          # f32 [NF]
    rto_backoff: torch.Tensor         # i32 [NF] consecutive-timeout count
    cc: CCState
    lb: reps.LBState
    m: Metrics


# --------------------------------------------------------------------------
# derivation
# --------------------------------------------------------------------------


def check_wire_rows(topo, n_nodes: int) -> None:
    """Raise unless each wire row has exactly one reader in the arrivals
    phase: the enqueue-capable emitters ``enq_ids`` and the delivery rows
    ``[QE, QE+N)`` partition ``[0, NE)``, and the real slots of the fan-in
    table ``in_tbl`` name each enqueue-capable emitter once.  The fused
    kernel zeroes each row through its one reader."""
    ne, eq = topo.n_emitters, len(topo.enq_ids)
    qe = topo.n_queues - n_nodes
    rows = np.concatenate([np.asarray(topo.enq_ids), np.arange(qe, qe + n_nodes)])
    tbl = np.asarray(topo.in_tbl)
    named = np.sort(tbl[tbl < eq])
    if not (np.array_equal(np.sort(rows), np.arange(ne))
            and np.array_equal(named, np.arange(eq))):
        raise ValueError(
            "the wire's rows need one reader each: enq_ids and the delivery rows "
            f"[{qe}, {qe + n_nodes}) must partition [0, {ne}), and in_tbl name each "
            "of the enqueue-capable emitters once")


def derive(cfg: SimConfig, wl: Workload, device="cuda"):
    """Map (config, workload) -> (Topology, Timing, Dims, Consts), with the
    constants on ``device`` (see :func:`resolve_device`)."""
    dev = resolve_device(device)
    link, tree = cfg.link, cfg.tree
    topo = build_topology(tree)
    tm = derive_timing(link, tree)

    N, NQ, NE = tree.n_nodes, topo.n_queues, topo.n_emitters
    NF = wl.n_flows
    wl.validate(n_nodes=N)   # reject bad tables before any shape math
    MTU = float(link.mtu_bytes)
    CAP = int(tm.brtt_inter)                      # 1 BDP per port queue
    max_pkts = int(np.ceil(wl.size.max() / MTU))
    # sent-ring slots: 1.5x the max window in packets, never wider than the
    # workload's own seq space (the reference's sizing, state.py:309-317)
    W = int(2 ** np.ceil(np.log2(max(1.5 * 1.25 * tm.brtt_inter, 32))))
    W = min(W, int(2 ** np.ceil(np.log2(max(max_pkts, 32)))))
    WW = W // 32
    L = tm.hop + 2
    R = int(max(tm.ret_inter, tm.trim_delay) + tm.hop + 4)
    MAXW = (max_pkts + 31) // 32
    P, U, M = tree.racks, tree.uplinks, tree.nodes_per_rack
    QE = NQ - N                                   # edge-port block base
    check_wire_rows(topo, N)

    # ---- per-flow constants (ACK return delay is globally constant) ----
    sr, dr = wl.src // M, wl.dst // M
    Pg = tree.racks_per_pod
    fwd_f = np.where(sr == dr, tm.fwd_intra,
                     np.where(sr // Pg == dr // Pg, tm.fwd_pod,
                              tm.fwd_inter))
    brtt_f = (fwd_f + tm.ret_inter).astype(np.float32)

    bdp = float(tm.brtt_inter * MTU)
    cc_params = make_cc_params(
        mtu=MTU, bdp=bdp, brtt=torch.from_numpy(brtt_f), device=dev,
        react_every=cfg.react_every,
        gamma=gamma(link, tm),
        use_trimming=cfg.trimming,
        **dict(cfg.cc_overrides),
    )
    lb_params = reps.make_lb_params(
        num_entropies=cfg.num_entropies,
        bdp_pkts=int(tm.brtt_inter),
        device=dev,
    )
    rto_mult = cfg.rto_mult or (3.0 if cfg.trimming else 2.0)
    rto_f = torch.tensor(rto_mult, dtype=F32, device=dev) * cc_params.trtt
    credit_window = cfg.credit_window_mult * bdp

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

    # ---- dependency table (the NF sentinel marks free slots) ----
    D = wl.n_deps
    if D:
        dep_par = np.asarray(wl.dep_par, np.int64).copy()
        dep_par[dep_par < 0] = NF
        dep_thr = np.asarray(wl.dep_thr, np.int64).copy()
        dep_thr[dep_par == NF] = 0          # free slots trivially satisfied
    else:
        dep_par = np.zeros((NF, 0), np.int64)
        dep_thr = np.zeros((NF, 0), np.int64)

    # ---- per-emitter wire latency (uniform within each emitter class) ----
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

    # ---- fault schedule compilation (host half of faults.py) ----
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

    # ---- pre-gathered routing tables (per-queue and per-flow) ----
    nbr = np.maximum(np.asarray(topo.nbr_sw[:NQ]), 0)
    sw_f = np.asarray(wl.src, np.int64) // M
    f_lo = np.asarray(topo.sw_lo)[sw_f]
    f_hi = np.asarray(topo.sw_hi)[sw_f]
    f_down = (wl.dst >= f_lo) & (wl.dst < f_hi)
    f_dn_q = (np.asarray(topo.dn_base)[sw_f]
              + np.asarray(wl.dst) // np.asarray(topo.dn_stride)[sw_f])

    # leaping is exact only when an event-free tick is a state no-op
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

    def i32(x):
        return torch.as_tensor(np.asarray(x, np.int32)).to(dev)

    def f32(x):
        return torch.tensor(x, dtype=F32, device=dev)

    def i64(x):
        return torch.as_tensor(np.asarray(x, np.int64)).to(dev)

    def boolean(x):
        return torch.as_tensor(np.asarray(x, bool)).to(dev)

    sw_salt = np.asarray(topo.sw_salt, np.uint32)
    consts = Consts(
        src=i32(wl.src),
        dst=i32(wl.dst),
        size=i32(wl.size),
        t_start=i32(wl.t_start),
        dep_par=i32(dep_par),
        dep_thr=i32(dep_thr),
        ret=i32(tm.ret_inter),
        flows_of=i32(flows_of),
        slot_of=i32(slot_of),
        flows_by_recv=i32(flows_by_recv),
        lat_q=i32(lat_q),
        ft_time=i32(cf.ft_time),
        ft_period=i32(cf.ft_period),
        fl_start=i32(cf.fl_start),
        fl_end=i32(cf.fl_end),
        fl_cycle=i32(cf.fl_cycle),
        fl_up=i32(cf.fl_up),
        fl_period=i32(cf.fl_period),
        fault_start=i32(cfg.fault_start),
        goodput_bin=i32(goodput_bin),
        trim_delay=i32(tm.trim_delay),
        kmin=f32(kmin),
        kspan=f32(kmax - kmin),
        rto=rto_f,
        credit_window=f32(credit_window),
        start_cwnd=f32(cfg.start_cwnd_mult * bdp),
        cc=cc_params,
        lb=lb_params,
        qidx=torch.arange(NQ, dtype=I32, device=dev),
        eidx=torch.arange(NE, dtype=I32, device=dev),
        flow_ids=torch.arange(NF, dtype=I32, device=dev),
        node_ids=torch.arange(N, dtype=I32, device=dev),
        nbr_q=i32(np.maximum(topo.nbr_sw[:NQ], 0)),
        edge_q=boolean(topo.nbr_sw[:NQ] < 0),
        sw_lo=i32(topo.sw_lo),
        sw_hi=i32(topo.sw_hi),
        sw_up_base=i32(topo.sw_up_base),
        sw_up_cnt=i32(topo.sw_up_cnt),
        sw_salt=i64(sw_salt),
        dn_base=i32(topo.dn_base),
        dn_stride=i32(topo.dn_stride),
        sw_of_q=i32(topo.sw_of_q),
        q_lo=i32(np.asarray(topo.sw_lo)[nbr]),
        q_hi=i32(np.asarray(topo.sw_hi)[nbr]),
        q_up_base=i32(np.asarray(topo.sw_up_base)[nbr]),
        q_up_cnt=i32(np.asarray(topo.sw_up_cnt)[nbr]),
        q_salt=i64(sw_salt[nbr]),
        q_dn_base=i32(np.asarray(topo.dn_base)[nbr]),
        q_dn_stride=i32(np.asarray(topo.dn_stride)[nbr]),
        f_down=boolean(f_down),
        f_dn_q=i32(f_dn_q),
        f_up_base=i32(np.asarray(topo.sw_up_base)[sw_f]),
        f_up_cnt=i32(np.asarray(topo.sw_up_cnt)[sw_f]),
        f_salt=i64(sw_salt[sw_f]),
        enq_ids=i32(topo.enq_ids),
        in_tbl=i32(topo.in_tbl),
        in_pos=i32(topo.in_pos),
        lat_core=i32(lat_q[0]),
        lat_edge=i32(lat_q[QE]),
        lat_send=i32(lat_q[NQ]),
        iota_l=torch.arange(L, dtype=I32, device=dev),
        iota_r=torch.arange(R, dtype=I32, device=dev),
    )
    return topo, tm, dims, consts


# Sentinel "no event in sight" horizon (i32-safe; run loops clamp it to the
# remaining tick budget before applying a leap).
HORIZON_INF = 1 << 30


class Clock(NamedTuple):
    """The constant delays that address the rings, and a host tick ``t``.

    A lane batch's ticks live on the device (``kernels.lanes.Tick``: each
    lane leaps by its own horizon, so their ticks differ); the kernels
    derive their ring slots from them.  The delays are read from
    ``Consts`` once per build (:func:`clock`); ``t`` is the host's tick of
    a single-lane state, for the single-lane entry points
    (``Sim.step``, ``Sim.phases``)."""

    t: int
    ret: int
    trim_delay: int
    lat_core: int
    lat_edge: int
    lat_send: int


def clock(consts: Consts, t: int = 0) -> Clock:
    """A :class:`Clock` at tick ``t`` (one device read of the delays)."""
    vals = torch.stack([consts.ret, consts.trim_delay, consts.lat_core,
                        consts.lat_edge, consts.lat_send]).tolist()
    return Clock(int(t), *(int(v) for v in vals))


# Counts calls of ``init_state``: the reference's ``"state.init"`` trace
# counter (``with trace_guard("state.init", expect=1): ...``,
# repro_torch.analysis).  A lane batch is one call.
_INIT_CALLS = _counter("state.init")


def init_state(dims: Dims, consts: Consts, n: int | None = None) -> SimState:
    """Tick-0 world on the constants' device.  With ``n``, the tick-0
    world of an ``n``-lane batch, every leaf ``[n, ...]``, from the
    batch's broadcast constants (``LaneConsts.b``: a swept scalar
    ``[n, 1]``, a swept vector ``[n, ...]``, a shared leaf as it is)."""
    _INIT_CALLS.hit()
    dev = consts.src.device
    NF, N, NQ = dims.NF, dims.N, dims.NQ
    lead = () if n is None else (int(n),)

    def zeros(shape, dtype=I32):
        return torch.zeros(lead + shape, dtype=dtype, device=dev)

    cc = init_cc_state(NF, consts.cc, start_cwnd=consts.start_cwnd, lead=lead)
    lb = reps.init_lb_state(NF, consts.lb, lead=lead)
    return SimState(
        now=zeros(()),
        salt=zeros(()),
        q_fields=zeros((NQ + 1, dims.CAP, 5)),
        q_head=zeros((NQ + 1,)),
        q_size=zeros((NQ + 1,)),
        infl=zeros((dims.L, dims.NE, 7)),
        ack_ring=zeros((dims.R, N, 6)),
        trim_ring=zeros((dims.R, NF + 1, 2 + dims.WW)),
        credit_ring=zeros((dims.R, NF + 1), F32),
        sent=zeros((3, NF + 1, dims.W)),
        next_seq=zeros((NF,)),
        unacked=zeros((NF,), F32),
        done=zeros((NF,), torch.bool),
        fct=torch.full(lead + (NF,), -1, dtype=I32, device=dev),
        goodput=zeros((NF,)),
        bitmap=zeros((NF + 1, dims.MAXW)),
        granted=zeros((NF,), F32),
        trim_seen=zeros((NF + 1,), F32),
        rr_recv=zeros((N,)),
        rr_send=zeros((N,)),
        pace_accum=zeros((NF,), F32),
        rto_backoff=zeros((NF,)),
        cc=cc, lb=lb, m=init_metrics(dev, lead),
    )


# --------------------------------------------------------------------------
# lane batches
# --------------------------------------------------------------------------


class LaneConsts(NamedTuple):
    """A lane batch's constants in the two forms its tick reads, made once
    a run from ``consts_b`` and ``axes`` (:func:`lane_consts`).

    ``b`` broadcasts against a ``[L, ...]`` state in PyTorch: a shared leaf
    as the run's, a swept one ``[L, *shape]`` with a scalar as ``[L, 1]``.
    ``l`` is every leaf ``[L, *shape]`` (a shared one an ``expand``-ed
    view, lane stride 0): the fused phases' operands."""

    b: Consts
    l: Consts
    n: int


def no_axes(tree):
    """An all-``None`` axes tree matching ``tree`` (nothing swept)."""
    return tree_map(lambda _: None, tree)


def lane_consts(consts_b: Consts, axes, n: int) -> LaneConsts:
    """The two forms of a batch's constants (``axes=None``: nothing swept)."""
    if axes is None:
        axes = no_axes(consts_b)

    def bcast(x, a):
        return x.reshape(n, 1) if a == 0 and x.dim() == 1 else x

    def lane(x, a):
        return x if a == 0 else x.expand((n,) + tuple(x.shape))
    return LaneConsts(b=tree_map(bcast, consts_b, axes),
                      l=tree_map(lane, consts_b, axes), n=n)


def init_lanes(dims: Dims, consts_b: Consts, axes, salts) -> SimState:
    """The tick-0 world of a lane batch on the constants' device: lane ``i``
    is :func:`init_state` under its own constants with the hash salt
    ``salts[i]``, every leaf along a leading ``[L]`` axis — one
    :func:`init_state` call for the whole batch, as the reference's one
    vmapped trace."""
    n = len(salts)
    st = init_state(dims, lane_consts(consts_b, axes, n).b, n)
    return st._replace(salt=torch.as_tensor(np.asarray(salts, np.int64)).to(
        dtype=I32, device=st.salt.device))


def unsqueeze(tree):
    """A single-lane state as a one-lane batch (views)."""
    return tree_map(lambda x: x.unsqueeze(0), tree)


# --------------------------------------------------------------------------
# conversion to and from numpy (states produced by the reference)
# --------------------------------------------------------------------------

_NESTED = {"cc": CCState, "lb": reps.LBState, "m": Metrics}


def from_numpy(tree, device) -> SimState:
    """The port's ``SimState`` from a reference ``SimState`` whose leaves
    are numpy arrays (any object with the same field names will do).
    Leaves keep their dtype (i32 / f32 / bool) and shape."""
    dev = resolve_device(device)

    def leaf(x):
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    def node(cls, obj):
        return cls(**{f: (node(_NESTED[f], getattr(obj, f)) if f in _NESTED
                          and cls is SimState else leaf(getattr(obj, f)))
                      for f in cls._fields})

    return node(SimState, tree)


def to_numpy(tree):
    """The same NamedTuple structure with every tensor leaf as numpy."""
    return tree_map(lambda x: x.detach().cpu().numpy()
                    if isinstance(x, torch.Tensor) else x, tree)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of one or more NamedTuple trees of the same
    structure (a ``SimState`` and its nested ``CCState``/``LBState``/
    ``Metrics``), keeping the structure."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a NamedTuple tree, in field order (the reference's
    pytree order)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for sub in tree for x in tree_leaves(sub)]
    return [tree]


def tree_unflatten(template, leaves):
    """A tree of ``template``'s structure holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def stack_lanes(states):
    """Host states (numpy leaves) stacked along a new leading lane axis."""
    return tree_map(lambda *xs: np.stack(xs), *states)


def lane(states, i: int):
    """Lane ``i`` of a lane-stacked state (views of a batch on the device)."""
    return tree_map(lambda x: x[i], states)
