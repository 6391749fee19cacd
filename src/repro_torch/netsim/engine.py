"""Time-stepped packet-level simulator — composition layer and run loop.

Execution model (DESIGN.md Sec. 6): one tick = one MTU serialization time;
every output port forwards at most one data packet per tick.  All state is
struct-of-arrays tensors on one device; a tick is the composition of six
phases, each ``(Dims, LaneConsts, SimState, Tick) -> SimState`` on a lane
batch:

  1. departures : ``fabric.departures``  (dequeue, RED mark, route, wire)
  2. arrivals   : ``fabric.arrivals``    (enqueue/trim/drop or deliver/ACK)
  3. control    : ``transport.control``  (ACK/trim/timeout -> CC + LB)
  4. grants     : ``sender.grants``      (EQDS pull credits; else none)
  5. sends      : ``sender.sends``       (arbitration, admission, emission)
  6. metrics    : ``metrics.account``    (occupancy accounting)

``build`` resolves the backends once, as the reference does: the CC update
(``cc_backend``), the departures phase (``departures_backend``), the
arrivals phase (``fabric_backend``), the control phase
(``transport_backend``) and the sends phase with the EQDS grants' pick
(``sender_backend``).  ``"kernel"`` (the default) launches the
hand-written CUDA kernels on the card and takes their plain versions on
the CPU; ``"plain"`` takes the plain versions everywhere.  The departures
phase is one fused launch (``kernels/departures``, the RED flip inside
it); ``"plain"`` is also its earlier design, the phase in PyTorch.  The
arrivals phase is one fused launch (``kernels/arrivals``); ``fabric_backend=
"split"`` runs it as the earlier design, the ``enqueue_rank`` kernel with
PyTorch around it.  The control phase is one fused launch
(``kernels/control``), which runs SMaRTT's window update too when the CC
backend is ``"kernel"``; ``transport_backend="split"`` runs it as the
earlier design, the ``ring_drain`` and ``cc_update`` kernels with PyTorch
between them.  The sends phase is one fused launch (``kernels/sends``);
``sender_backend="split"`` runs it as the earlier design, the ``rr_pick``
kernel with PyTorch around it.  The grants phase (EQDS only) picks
through the ``rr_pick`` kernel under ``"kernel"`` and ``"split"`` alike.
Every phase updates the state's buffers in place: a state passed to a
phase (or to ``Sim.step``) is consumed.

Every phase runs on a lane batch: a state whose every leaf carries a
leading ``[L]`` axis, one lane a run (``state.init_lanes``), each lane at
its own tick (``kernels.lanes.Tick``: the ticks and the lane gate on the
device, where the kernels read them, and the host's copies).  A lane that
is not live is a bitwise no-op: the kernels return at once for it and the
PyTorch of the tick writes it nowhere.  The run loop is ``shard.py``'s
lane loop, the reference's gated superstep loop written as a Python loop
over the batch: each superstep first leaps each lane to its own next
event horizon (one host read of the ``[L]`` leaps, DESIGN.md Sec. 6.3),
then runs up to K batched ticks, one launch of each fused kernel for all
live lanes, each tick followed by one host read of the ``[L]`` gate.
Leap-on equals leap-off and every K equals K = 1 over the whole state,
as in the reference, and each lane equals its standalone run.

``Sim.run`` is the batch of one lane; ``Sim.run_batch`` (the seed-only
study) and the experiment API's studies (``netsim/api.py``) run their
lanes as one batch through ``shard.run_lanes``, or over a mesh of
devices, one loop a shard.  ``Sim.run_trace`` is the
reference's traced scan on one lane: every tick from ``init()``, no exit
gate and no leap, each tick's outputs written into preallocated tensors
on the device.  ``Sim.step``, ``Sim.horizon`` and ``Sim.phases`` take a
single-lane state at a host tick (a batch of one lane of views).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.analysis.trace_guard import span
from repro_torch.core import registry
from repro_torch.kernels import lanes
from repro_torch.kernels.arrivals import ops as arrivals_ops
from repro_torch.kernels.control import ops as control_ops
from repro_torch.kernels.departures import ops as departures_ops
from repro_torch.kernels.departures import ref as departures_ref
from repro_torch.kernels.ring_drain import ops as ring_drain_ops
from repro_torch.kernels.sends import ops as sends_ops
from repro_torch.netsim import fabric, metrics, sender, transport
from repro_torch.netsim.metrics import HIST_BINS, jain_fairness, summarize  # noqa: F401
from repro_torch.netsim.state import (Clock, Consts, Dims, LaneConsts,  # noqa: F401
                                      SimConfig, SimState, clock, derive, init_lanes,
                                      init_state, lane, lane_consts, stack_lanes, to_numpy,
                                      unsqueeze)
from repro_torch.netsim.topology import Topology
from repro_torch.netsim.units import Timing
from repro_torch.netsim.workloads import Workload

I32 = torch.int32
F32 = torch.float32


# the span of each tick phase (``trace_guard.span``), named once
TICK_SPANS = {name: "tick." + name for name in
              ("departures", "arrivals", "control", "grants", "sends", "metrics")}


@dataclasses.dataclass(frozen=True)
class Sim:
    """A built simulator: configuration, derived tables, and the tick."""

    cfg: SimConfig
    topo: Topology
    timing: Timing
    wl: Workload
    dims: Dims
    consts: Consts
    device: torch.device
    lane_phases: tuple      # ordered ((name, (LaneConsts, SimState, Tick) ->
                            #   SimState), ...) — the six tick sub-steps of a
                            #   lane batch
    clock0: Clock           # the ring delays, at tick 0
    stats: dict             # the last run's counts: "steps" (ticks executed)
                            #   and "leaps" (supersteps that leapt ahead) of
                            #   its lane 0, and "lanes": the batch's (steps,
                            #   leaps, ticks a lane; "batch_ticks", the
                            #   batched ticks, one launch of each kernel each;
                            #   "shard_ticks", each shard's over a mesh)
    cache: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def phases(self) -> tuple:
        """The six phases on a single-lane state at a host tick:
        ``((name, (Consts, SimState, Clock) -> SimState), ...)``."""
        return tuple((name, _one_lane(self, fn)) for name, fn in self.lane_phases)

    def tick(self, c: LaneConsts, st: SimState, k: lanes.Tick) -> SimState:
        """One batched tick: each live lane advances one tick, the others
        are left as they were (consumed: the rings are updated in place)."""
        for name, phase in self.lane_phases:
            with span(TICK_SPANS[name]):
                st = phase(c, st, k)
        return st._replace(now=st.now + k.live)

    def horizon_lanes(self, c: LaneConsts, st: SimState, t):
        """Each lane's distance (ticks, i32 [L]) to its next eventful tick —
        min over the per-phase next-event reductions (DESIGN.md Sec. 6.3);
        ``t`` the lanes' ticks as an i32 ``[L, 1]`` column."""
        d, cb = self.dims, c.b
        h = fabric.horizon(d, cb, st, t)
        h = torch.minimum(h, transport.horizon(d, cb, st, t))
        return torch.minimum(h, sender.horizon(d, cb, st, t))

    def step(self, st: SimState, t: int | None = None) -> SimState:
        """One tick from a single-lane ``st`` (consumed: its rings are
        updated in place).  ``t`` is the host's copy of ``st.now``;
        without it, it is read."""
        t = int(st.now) if t is None else int(t)
        out = self.tick(self.lanes_of(None, 1), unsqueeze(st), _live_tick(st, t))
        return lane(out, 0)

    def horizon(self, st: SimState, t: int | None = None):
        """A single-lane state's distance (0-d) to its next eventful tick."""
        t = int(st.now) if t is None else int(t)
        tcol = torch.full((1, 1), t, dtype=I32, device=self.device)
        return self.horizon_lanes(self.lanes_of(None, 1), unsqueeze(st), tcol)[0]

    def init(self) -> SimState:
        return init_state(self.dims, self.consts)

    def lanes_of(self, consts_b=None, n: int = 1, axes=None) -> LaneConsts:
        """The :class:`LaneConsts` of an ``n``-lane batch of this simulator
        (``consts_b=None``: its own constants, shared by every lane), made
        once per batch shape and kept."""
        cb = self.consts if consts_b is None else consts_b
        key = (id(cb), id(axes), n)
        hit = self.cache.get("lane_consts")
        if hit is None or hit[0] != key or hit[1] is not cb or hit[2] is not axes:
            hit = self.cache["lane_consts"] = (key, cb, axes, lane_consts(cb, axes, n))
        return hit[3]

    def run(self, max_ticks: int, seed: int = 0) -> SimState:
        """Run to completion (or ``max_ticks``) as a batch of one lane.
        ``seed`` sets the per-run hash salt (RED/ECMP decorrelation) — seed
        0 is the default."""
        from repro_torch.netsim import shard

        st = init_lanes(self.dims, self.consts, None, [int(seed)])
        out = shard._run_lanes(self, self.consts, None, st, int(max_ticks))
        return lane(out, 0)

    def run_trace(self, ticks: int, trace_flows: int = 8):
        """``ticks`` ticks from ``init()`` with per-tick outputs, as the
        reference's ``lax.scan`` (engine.py:277-294): no exit gate and no
        leap.  Returns ``(state, ys)``; ``ys`` holds ``cwnd[:tf]``,
        ``q_mean``, ``q_max``, ``delivered``, ``goodput[:tf]`` and ``done``
        (the count of finished flows), each stacked ``[ticks, ...]`` on the
        sim's device."""
        return _run_trace(self, int(ticks), int(trace_flows))

    def run_batch(self, seeds, max_ticks: int, mesh=None):
        """The seed-only study: one lane a seed, each equal to its
        standalone ``run(seed=s)``, run as one batch
        (``shard.run_lanes``); the final states copied to the host, stacked
        along a leading ``[len(seeds)]`` axis (the reference's batched state
        after ``jax.device_get``).  ``mesh``: the devices to spread the
        lanes over (``shard.run_lanes``)."""
        from repro_torch.netsim import shard

        seeds = [int(s) for s in seeds]
        if len(seeds) > 1:
            check_lane_backends(self.cfg)
        st = init_lanes(self.dims, self.consts, None, seeds)
        return to_numpy(shard.run_lanes(self, self.consts, None, st, int(max_ticks),
                                        mesh=mesh))


# The earlier designs' backends, kept to time the fused phases against
# them on one lane, run no lane batch.
LANE_TODO = ("{key}={value!r} (an earlier design's backend) runs one lane; a "
             "study or a seed batch runs the fused phases (ROADMAP.md Queue 1)")


def check_lane_backends(cfg: SimConfig) -> None:
    """Raise ``NotImplementedError`` where ``cfg`` names an earlier design's
    backend, which runs no batch of several lanes, nor a mesh."""
    for key, value in (("departures_backend", "plain"), ("fabric_backend", "split"),
                       ("sender_backend", "split"), ("transport_backend", "split")):
        if getattr(cfg, key) == value:
            raise NotImplementedError(LANE_TODO.format(key=key, value=value))


_LIVE: dict = {}


def _live_tick(st: SimState, t: int) -> lanes.Tick:
    """A single-lane state's clock at host tick ``t``: its ``now`` as the
    batch's, the gate open."""
    dev = st.now.device
    if dev not in _LIVE:
        _LIVE[dev] = torch.ones((1,), dtype=torch.bool, device=dev)
    return lanes.Tick(st.now.reshape(1), _LIVE[dev], (int(t),), (True,))


def _one_lane(sim: Sim, fn):
    """A lane-batch phase as a single-lane one, ``(Consts, SimState, Clock)
    -> SimState``: the state as a batch of one lane of views."""
    def run(consts, st, clk):
        out = fn(sim.lanes_of(consts, 1), unsqueeze(st), _live_tick(st, clk.t))
        return lane(out, 0)
    return run


def build(cfg: SimConfig, wl: Workload, device="cuda") -> Sim:
    """Derive the tables on ``device`` and compose the tick.  The card is
    the default; ``device="cpu"`` runs the plain versions on the CPU."""
    cc_update = registry.get(cfg.algo, cfg.cc_backend)
    depart = departures_ops.get(cfg.departures_backend)
    land = arrivals_ops.get(cfg.fabric_backend)
    send, arb = sends_ops.get(cfg.sender_backend), sends_ops.grant_pick(cfg.sender_backend)
    run = None if cfg.transport_backend == "split" else \
        control_ops.get(cfg.transport_backend)
    topo, tm, dims, consts = derive(cfg, wl, device)
    clock0 = clock(consts)
    dfl = fabric.departures_flags(dims)
    lat = departures_ref.Lat(core=clock0.lat_core, edge=clock0.lat_edge)
    afl = fabric.flags(dims, consts, clock0)
    sfl = sender.flags(dims)

    def arrivals(c, st, k):
        return fabric.arrivals(dims, c, st, k, run=land, trim_delay=clock0.trim_delay,
                               fl=afl)
    if run is None:
        def control(c, st, k):
            return transport.control_split(dims, c, cc_update, st, k,
                                           drain=ring_drain_ops.ring_drain)
    else:
        fl = transport.flags(cfg, dims)

        def control(c, st, k):
            return transport.control(dims, c, cc_update, st, k, run=run, fl=fl)

    phases = (
        ("departures", lambda c, st, k: fabric.departures(dims, c, st, k, run=depart,
                                                          lat=lat, fl=dfl)),
        ("arrivals", arrivals),
        ("control", control),
        ("grants", lambda c, st, k: sender.grants(dims, c, st, k, arb=arb,
                                                  ret=clock0.ret)),
        ("sends", lambda c, st, k: sender.sends(dims, c, st, k, run=send,
                                                lat_send=clock0.lat_send, fl=sfl)),
        ("metrics", lambda c, st, k: metrics.account(dims, c, st, k)),
    )
    return Sim(cfg=cfg, topo=topo, timing=tm, wl=wl, dims=dims, consts=consts,
               device=consts.src.device, lane_phases=phases,
               clock0=clock0, stats={})


def _run_until_done(sim: Sim, st: SimState, max_ticks: int) -> SimState:
    """A single-lane state run on to completion (or ``max_ticks``) as a
    batch of one lane (``shard._run_lanes``)."""
    from repro_torch.netsim import shard

    return lane(shard._run_lanes(sim, sim.consts, None, unsqueeze(st), int(max_ticks)), 0)


def _run_trace(sim: Sim, ticks: int, tf: int):
    """The reference's traced scan (engine.py:277-294) as a Python loop
    over a batch of one lane.  Each tick writes its outputs into
    preallocated tensors on the sim's device, so a traced tick reads
    nothing back to the host.  ``q_mean`` is the exact integer sum of the
    queue sizes times the f32 reciprocal of the queue count: XLA compiles
    the reference's ``jnp.mean`` to that product (a divide by a constant
    becomes a multiply by its reciprocal), so this is its value bit for
    bit, where the IEEE quotient differs by an ULP on some ticks."""
    nq, dev = sim.dims.NQ, sim.device
    c = sim.lanes_of(None, 1)
    st = init_lanes(sim.dims, sim.consts, None, [0])
    ncw, ngp = st.cc.cwnd[0, :tf].shape[0], st.goodput[0, :tf].shape[0]
    ys = dict(cwnd=torch.empty((ticks, ncw), dtype=F32, device=dev),
              q_mean=torch.empty((ticks,), dtype=F32, device=dev),
              q_max=torch.empty((ticks,), dtype=I32, device=dev),
              delivered=torch.empty((ticks,), dtype=F32, device=dev),
              goodput=torch.empty((ticks, ngp), dtype=I32, device=dev),
              done=torch.empty((ticks,), dtype=I32, device=dev))
    inv_nq = torch.tensor(np.float32(1) / np.float32(nq), dtype=F32, device=dev)
    live = torch.ones((1,), dtype=torch.bool, device=dev)
    for t in range(ticks):
        st = sim.tick(c, st, lanes.Tick(st.now, live, (t,), (True,)))
        q = st.q_size[0, :nq]
        ys["cwnd"][t] = st.cc.cwnd[0, :tf]
        torch.mul(metrics.isum(q).to(F32), inv_nq, out=ys["q_mean"][t])
        ys["q_max"][t] = torch.max(q)
        ys["delivered"][t] = st.m.delivered_bytes[0]
        ys["goodput"][t] = st.goodput[0, :tf]
        ys["done"][t] = metrics.isum(st.done[0])
    sim.stats.update(steps=ticks, leaps=0, ticks=ticks)
    return lane(st, 0), ys
