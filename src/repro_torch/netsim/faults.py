"""Dynamic link-fault schedules (paper Sec. 4 / Fig. 7's degraded fabric).

The historical fault model was a static port set that switches on at one
``fault_start`` and never changes.  This module generalizes it to a
:class:`FaultSchedule` — a timeline of per-port (or per-switch, expanding
to every port the switch owns) fail / degrade / repair events plus
periodic flapping windows — while keeping the compiled form small enough
to live in ``Consts`` and be evaluated branch-free every tick:

* ``compile_tables`` turns a schedule into per-port *transition tables*
  ``ft_time`` / ``ft_period`` of static shape [NQ, FK] (``FK`` columns =
  1 + max events on any one port; both are ``Dims`` statics).  Column 0
  is always the healthy state ``(t=0, period=1)``; real events follow in
  time order, padded with ``(HORIZON_INF, 1)``.  The service period of
  port q at tick t is then the last column whose time is <= t — one
  comparison + ``take_along_axis`` per tick (:func:`port_period`).

* Times in the tables are *relative to* ``Consts.fault_start`` (the
  evaluation uses ``t - fault_start``), so ``fault_start`` stays a plain
  sweepable scalar exactly as before: legacy ``faults=((kind,i,j,p),...)``
  tuples lower (:func:`lower`) to one-event schedules whose compiled
  evaluation is bit-for-bit the historical
  ``where(t >= fault_start, period, healthy)``.

* Period semantics match the historical ``Consts.service_period``:
  ``1`` = healthy, ``0`` = dead (packets blackhole), ``k > 1`` = degraded
  (the port serves only when ``t % k == 0`` — the *absolute* tick, so the
  lowered form reproduces the legacy modulus bitwise).

* Flaps compile to per-port scalars (``fl_start/fl_end/fl_cycle/fl_up/
  fl_period``): inside ``[start, end)`` the port cycles ``up`` healthy
  ticks then ``cycle - up`` ticks at ``period`` (0 = dead while down).
  At most one flap per port.

This is the host half of the reference ``netsim/faults.py``: schedule
types, lowering, validation and table compilation.  ``state.derive``
compiles every configuration's (possibly empty) schedule, so the tables'
shapes and the ``FK``/``flapped`` statics match the reference leaf by
leaf.  The per-tick evaluation (``port_period``, ``fault_active``,
``transition_horizon``) is not ported yet, so ``state.derive`` refuses a
non-empty schedule instead of running it without its faults.
"""

from __future__ import annotations

import dataclasses

import numpy as np

HORIZON_INF = 1 << 30

# port kinds resolvable by (kind, i, j); "switch" takes a switch id in
# ``i`` and expands to every queue that switch owns
PORT_KINDS = ("t0_up", "t1_up", "t2_down", "t1_down")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """At tick ``t`` (relative to ``fault_start``) set the target's
    service period: 0 = fail dead, k > 1 = degrade to serve every k-th
    tick, 1 = repair to healthy."""
    t: int
    kind: str           # one of PORT_KINDS, or "switch"
    i: int
    j: int = 0
    period: int = 0


@dataclasses.dataclass(frozen=True)
class Flap:
    """Periodic flapping of one target inside ``[t, t_end)``: each
    ``cycle``-tick window is ``up`` healthy ticks followed by
    ``cycle - up`` ticks at ``period`` (default 0 = dead)."""
    kind: str
    i: int
    up: int
    cycle: int
    j: int = 0
    t: int = 0
    t_end: int = HORIZON_INF
    period: int = 0


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    events: tuple = ()
    flaps: tuple = ()

    def __bool__(self) -> bool:
        return bool(self.events or self.flaps)


def lower(faults) -> FaultSchedule:
    """Lower ``SimConfig.faults`` to a :class:`FaultSchedule`.

    Accepts a schedule verbatim, or the legacy tuple forms — 3-tuples
    ``(r, a, period)`` / 4-tuples ``(kind, i, j, period)`` — each
    becoming a single event at relative t=0 (i.e. absolute
    ``fault_start``, which stays a separate sweepable scalar)."""
    if isinstance(faults, FaultSchedule):
        return faults
    events = []
    for f in faults:
        f = tuple(f)
        if len(f) == 3 and not isinstance(f[0], str):
            kind, i, j, period = "t0_up", f[0], f[1], f[2]
        elif len(f) == 4 and isinstance(f[0], str):
            kind, i, j, period = f
        else:
            raise ValueError(
                f"fault tuple {f!r} not understood: want (r, a, period) or "
                f"(kind, i, j, period) with kind one of {PORT_KINDS}"
                f" or 'switch', or pass a FaultSchedule")
        events.append(FaultEvent(t=0, kind=kind, i=i, j=j, period=period))
    return FaultSchedule(events=tuple(events))


def resolve_ports(topo, kind: str, i: int, j: int, ctx: str) -> list:
    """Queue ids targeted by ``(kind, i, j)``, with actionable range
    validation (mirrors ``Workload.validate``): ``ctx`` names the
    offending schedule entry in errors."""
    tree = topo.tree

    def _chk(name, v, hi):
        if not 0 <= v < hi:
            raise ValueError(
                f"{ctx}: {name}={v} out of range [0, {hi}) for "
                f"kind={kind!r} on this tree")

    if kind == "switch":
        _chk("switch", i, topo.n_switches)
        return [int(q) for q in np.where(topo.sw_of_q == i)[0]]
    if kind not in PORT_KINDS:
        raise ValueError(
            f"{ctx}: unknown fault kind {kind!r} "
            f"(want one of {PORT_KINDS} or 'switch')")
    if kind in ("t1_up", "t2_down") and not tree.pods:
        raise ValueError(
            f"{ctx}: kind={kind!r} exists only on three-tier trees "
            f"(this tree has pods=0)")
    if kind == "t0_up":
        _chk("i (rack)", i, tree.racks)
        _chk("j (uplink)", j, tree.uplinks)
    elif kind == "t1_up":
        _chk("i (t1 switch)", i, tree.n_t1)
        _chk("j (core uplink)", j, tree.core_uplinks)
    elif kind == "t2_down":
        _chk("i (core)", i, tree.n_cores)
        _chk("j (pod)", j, tree.pods)
    elif kind == "t1_down":
        _chk("i (t1 switch)", i, tree.n_t1)
        _chk("j (rack-in-pod)", j, tree.racks_per_pod)
    return [int(getattr(topo, kind)(i, j))]


def validate(sched: FaultSchedule, fault_start: int) -> None:
    """Schedule-shape errors that don't need the topology."""
    if fault_start < 0:
        raise ValueError(f"fault_start={fault_start} must be >= 0")
    for ev in sched.events:
        if ev.t < 0:
            raise ValueError(f"fault event {ev}: t must be >= 0")
        if ev.period < 0:
            raise ValueError(
                f"fault event {ev}: period must be >= 0 "
                f"(0 = dead, 1 = healthy, k > 1 = degraded)")
    for fl in sched.flaps:
        if fl.t < 0 or fl.t_end <= fl.t:
            raise ValueError(f"flap {fl}: need 0 <= t < t_end")
        if fl.cycle < 2 or not 0 < fl.up < fl.cycle:
            raise ValueError(
                f"flap {fl}: need cycle >= 2 and 0 < up < cycle")
        if fl.period < 0:
            raise ValueError(f"flap {fl}: period must be >= 0")


@dataclasses.dataclass(frozen=True)
class CompiledFaults:
    """Numpy transition tables + static shape bits (see module doc)."""
    ft_time: np.ndarray     # [NQ, FK] i32, row-sorted, col0 = (0, 1)
    ft_period: np.ndarray   # [NQ, FK] i32
    fl_start: np.ndarray    # [NQ] i32
    fl_end: np.ndarray      # [NQ] i32 (HORIZON_INF = open)
    fl_cycle: np.ndarray    # [NQ] i32 (0 = no flap on this port)
    fl_up: np.ndarray       # [NQ] i32
    fl_period: np.ndarray   # [NQ] i32
    FK: int                 # 0 = no timeline events at all
    flapped: bool


def compile_tables(sched: FaultSchedule, topo,
                   fault_start: int = 0) -> CompiledFaults:
    """Compile a schedule against a topology (validating every entry)."""
    validate(sched, fault_start)
    NQ = topo.n_queues
    per_port: dict = {}
    for k, ev in enumerate(sched.events):
        for q in resolve_ports(topo, ev.kind, ev.i, ev.j,
                               f"faults[{k}] = {ev}"):
            per_port.setdefault(q, []).append((ev.t, ev.period))
    maxev = max((len(v) for v in per_port.values()), default=0)
    FK = 1 + maxev if per_port else 0
    ft_time = np.full((NQ, max(FK, 1)), HORIZON_INF, np.int32)
    ft_period = np.ones((NQ, max(FK, 1)), np.int32)
    ft_time[:, 0] = 0                      # column 0: healthy from t=0
    for q, evs in per_port.items():
        evs.sort(key=lambda e: e[0])       # stable: later-listed wins ties
        for k, (et, ep) in enumerate(evs):
            ft_time[q, 1 + k] = et
            ft_period[q, 1 + k] = ep

    fl_start = np.zeros(NQ, np.int32)
    fl_end = np.zeros(NQ, np.int32)
    fl_cycle = np.zeros(NQ, np.int32)
    fl_up = np.zeros(NQ, np.int32)
    fl_period = np.zeros(NQ, np.int32)
    for k, fl in enumerate(sched.flaps):
        for q in resolve_ports(topo, fl.kind, fl.i, fl.j,
                               f"flaps[{k}] = {fl}"):
            if fl_cycle[q]:
                raise ValueError(
                    f"flaps[{k}] = {fl}: port {q} already has a flap "
                    f"(at most one flap per port)")
            fl_start[q] = fl.t
            fl_end[q] = min(fl.t_end, HORIZON_INF)
            fl_cycle[q] = fl.cycle
            fl_up[q] = fl.up
            fl_period[q] = fl.period
    return CompiledFaults(ft_time=ft_time, ft_period=ft_period,
                          fl_start=fl_start, fl_end=fl_end,
                          fl_cycle=fl_cycle, fl_up=fl_up,
                          fl_period=fl_period, FK=FK,
                          flapped=bool(sched.flaps))
