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

* :func:`transition_horizon` is the leap clamp (DESIGN.md Sec. 6.3): the
  distance to the next schedule transition strictly after ``t`` (table
  times and flap phase boundaries), which ``fabric.horizon`` min's in so
  a time leap never jumps across a fault state change.

Host-side mirrors (:func:`np_port_period`, :func:`fault_ticks`,
:func:`repair_times`) integrate the same piecewise-constant activity
function exactly for the recovery metrics in ``api.RunResult`` — no
device accounting needed beyond the delivered-during-fault counter.
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


# ---- traced evaluation (consts carries the tables; dims the shape) ----

def port_period(dims, consts, t):
    """[NQ] service period of every port at absolute tick ``t`` (1 =
    healthy, 0 = dead, k > 1 = degraded).  Gated on the static
    ``dims.FK`` / ``dims.flapped`` so no-fault configs keep a clean
    graph.  Table times are relative to ``consts.fault_start``."""
    from . import np32 as jnp
    tr = t - consts.fault_start
    if dims.FK:
        cnt = jnp.sum((tr >= consts.ft_time).astype(jnp.int32), axis=1)
        idx = jnp.maximum(cnt - 1, 0)      # tr < 0 -> healthy column 0
        per = jnp.take_along_axis(consts.ft_period, idx[:, None],
                                  axis=1)[:, 0]
    else:
        per = jnp.ones((dims.NQ,), jnp.int32)
    if dims.flapped:
        has = consts.fl_cycle > 0
        cyc = jnp.maximum(consts.fl_cycle, 1)
        ph = (tr - consts.fl_start) % cyc
        in_win = has & (tr >= consts.fl_start) & (tr < consts.fl_end)
        down = in_win & (ph >= consts.fl_up)
        per = jnp.where(down, consts.fl_period, per)
    return per


def fault_active(dims, consts, t):
    """Scalar bool: any port not healthy at tick ``t``."""
    from . import np32 as jnp
    return jnp.any(port_period(dims, consts, t) != 1)


def transition_horizon(dims, consts, t):
    """Ticks until the next schedule transition strictly after ``t`` —
    the leap clamp.  Over ``[t, t + horizon)`` every port's period is
    constant, so fault activity cannot change inside a leap window."""
    from . import np32 as jnp
    I32 = jnp.int32
    tr = t - consts.fault_start
    h = jnp.asarray(HORIZON_INF, I32)
    if dims.FK:
        dt = jnp.where(consts.ft_time > tr,
                       consts.ft_time - tr, HORIZON_INF)
        h = jnp.minimum(h, jnp.min(dt))
    if dims.flapped:
        has = consts.fl_cycle > 0
        cyc = jnp.maximum(consts.fl_cycle, 1)
        ph = (tr - consts.fl_start) % cyc
        to_bound = jnp.where(ph < consts.fl_up,
                             consts.fl_up - ph, cyc - ph)
        before = has & (tr < consts.fl_start)
        inside = has & (tr >= consts.fl_start) & (tr < consts.fl_end)
        d = jnp.where(
            before, consts.fl_start - tr,
            jnp.where(inside,
                      jnp.minimum(to_bound, consts.fl_end - tr),
                      HORIZON_INF))
        h = jnp.minimum(h, jnp.min(d))
    return jnp.maximum(h, 1)


# ---- host-side mirrors (recovery metrics in api.RunResult) ----

def np_port_period(cf: CompiledFaults, fault_start: int, t: int):
    """Numpy mirror of :func:`port_period` (same definition, exact)."""
    tr = t - fault_start
    if cf.FK:
        idx = np.maximum((tr >= cf.ft_time).sum(axis=1) - 1, 0)
        per = np.take_along_axis(cf.ft_period, idx[:, None], axis=1)[:, 0]
    else:
        per = np.ones(cf.ft_time.shape[0], np.int32)
    if cf.flapped:
        has = cf.fl_cycle > 0
        cyc = np.maximum(cf.fl_cycle, 1)
        ph = (tr - cf.fl_start) % cyc
        in_win = has & (tr >= cf.fl_start) & (tr < cf.fl_end)
        per = np.where(in_win & (ph >= cf.fl_up), cf.fl_period, per)
    return per


def _breakpoints(cf: CompiledFaults, fault_start: int, ticks: int):
    """Sorted absolute ticks in [0, ticks) where activity may change."""
    pts = {0}
    for tt in np.unique(cf.ft_time):
        at = int(tt) + fault_start
        if 0 <= at < ticks and tt < HORIZON_INF:
            pts.add(at)
    if cf.flapped:
        for q in np.where(cf.fl_cycle > 0)[0]:
            cyc, up = int(cf.fl_cycle[q]), int(cf.fl_up[q])
            s = int(cf.fl_start[q]) + fault_start
            e = min(int(cf.fl_end[q]) + fault_start, ticks)
            k = s
            while k < e:
                for b in (k, k + up):
                    if 0 <= b < min(e, ticks):
                        pts.add(b)
                k += cyc
            if 0 <= e < ticks:
                pts.add(e)
    return sorted(pts)


def fault_ticks(cf: CompiledFaults, fault_start: int, ticks: int) -> int:
    """Exact count of ticks in [0, ticks) with any port unhealthy —
    integrates the same piecewise-constant function the fabric evaluates
    (activity is constant between breakpoints), so no device counter is
    needed."""
    if not (cf.FK or cf.flapped) or ticks <= 0:
        return 0
    pts = _breakpoints(cf, fault_start, ticks) + [ticks]
    total = 0
    for a, b in zip(pts[:-1], pts[1:]):
        if np.any(np_port_period(cf, fault_start, a) != 1):
            total += b - a
    return int(total)


def repair_times(cf: CompiledFaults, fault_start: int, ticks: int) -> list:
    """Absolute ticks in (0, ticks) where the fabric transitions from
    fault-active to all-healthy — the anchors for time-to-recover."""
    if not (cf.FK or cf.flapped) or ticks <= 0:
        return []
    pts = _breakpoints(cf, fault_start, ticks)
    out, prev = [], False
    for a in pts:
        act = bool(np.any(np_port_period(cf, fault_start, a) != 1))
        if prev and not act and a > 0:
            out.append(int(a))
        prev = act
    return out


def first_fault_time(cf: CompiledFaults, fault_start: int,
                     ticks: int) -> int:
    """First absolute tick in [0, ticks) with any port unhealthy
    (-1 if the schedule never activates inside the run)."""
    if not (cf.FK or cf.flapped) or ticks <= 0:
        return -1
    for a in _breakpoints(cf, fault_start, ticks):
        if np.any(np_port_period(cf, fault_start, a) != 1):
            return int(a)
    return -1
