"""Time-stepped packet-level simulator — composition layer and run loop.

Execution model (DESIGN.md Sec. 6): one tick = one MTU serialization time;
every output port forwards at most one data packet per tick.  All state is
struct-of-arrays tensors on one device; a tick is the composition of six
phases, each ``(Dims, Consts, SimState, Clock) -> SimState``:

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

The run loop is the reference's gated superstep loop written as a Python
loop: each superstep first leaps ``now`` to the next event horizon (one
host read of the horizon, DESIGN.md Sec. 6.3), then runs up to K ticks,
each gated on the exit predicate (one host read a tick).  Leap-on equals
leap-off and every K equals K = 1 over the whole state, as in the
reference.  The host keeps the tick ``t`` itself (``state.Clock``), so no
phase waits on the device to address a ring.

``Sim.run_trace`` is the reference's traced scan: every tick from
``init()``, no exit gate and no leap, each tick's outputs written into
preallocated tensors on the device.  ``Sim.run_batch`` is the seed-only
study of the experiment API (``netsim/api.py``): the seeds run one after
another and their final states come back stacked on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import registry
from repro_torch.kernels.arrivals import ops as arrivals_ops
from repro_torch.kernels.control import ops as control_ops
from repro_torch.kernels.departures import ops as departures_ops
from repro_torch.kernels.ring_drain import ops as ring_drain_ops
from repro_torch.kernels.sends import ops as sends_ops
from repro_torch.netsim import fabric, metrics, sender, transport
from repro_torch.netsim.metrics import HIST_BINS, jain_fairness, summarize  # noqa: F401
from repro_torch.netsim.state import (Clock, Consts, Dims, SimConfig,  # noqa: F401
                                      SimState, clock, derive, init_state,
                                      stack_lanes, to_numpy)
from repro_torch.netsim.topology import Topology
from repro_torch.netsim.units import Timing
from repro_torch.netsim.workloads import Workload

I32 = torch.int32
F32 = torch.float32


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
    phases: tuple           # ordered ((name, (Consts, SimState, Clock) ->
                            #   SimState), ...) — the six tick sub-steps
    clock0: Clock           # the ring delays, at tick 0
    stats: dict             # the last run's counts: "steps" (ticks executed)
                            #   and "leaps" (supersteps that leapt ahead)

    def step(self, st: SimState, t: int | None = None) -> SimState:
        """One tick from ``st`` (consumed: its rings are updated in place).
        ``t`` is the host's copy of ``st.now``; without it, it is read."""
        clk = self.clock0._replace(t=int(st.now) if t is None else int(t))
        for _, phase in self.phases:
            st = phase(self.consts, st, clk)
        return st._replace(now=st.now + 1)

    def horizon(self, st: SimState, t: int | None = None):
        """Distance (ticks) to the next eventful tick — min over the
        per-phase next-event reductions (DESIGN.md Sec. 6.3)."""
        clk = self.clock0._replace(t=int(st.now) if t is None else int(t))
        d, c = self.dims, self.consts
        h = fabric.horizon(d, c, st, clk)
        h = torch.minimum(h, transport.horizon(d, c, st, clk))
        return torch.minimum(h, sender.horizon(d, c, st, clk))

    def init(self) -> SimState:
        return init_state(self.dims, self.consts)

    def run(self, max_ticks: int, seed: int = 0) -> SimState:
        """Run to completion (or ``max_ticks``).  ``seed`` sets the per-run
        hash salt (RED/ECMP decorrelation) — seed 0 is the default."""
        st = self.init()
        if seed:
            st = st._replace(salt=torch.tensor(seed, dtype=I32, device=self.device))
        return _run_until_done(self, st, int(max_ticks))

    def run_trace(self, ticks: int, trace_flows: int = 8):
        """``ticks`` ticks from ``init()`` with per-tick outputs, as the
        reference's ``lax.scan`` (engine.py:277-294): no exit gate and no
        leap.  Returns ``(state, ys)``; ``ys`` holds ``cwnd[:tf]``,
        ``q_mean``, ``q_max``, ``delivered``, ``goodput[:tf]`` and ``done``
        (the count of finished flows), each stacked ``[ticks, ...]`` on the
        sim's device."""
        return _run_trace(self, self.init(), int(ticks), int(trace_flows))

    def run_batch(self, seeds, max_ticks: int, mesh=None):
        """The seed-only study: one run a seed, each equal to its standalone
        ``run(seed=s)``, the final states copied to the host and stacked
        along a leading ``[len(seeds)]`` axis (the reference's batched state
        after ``jax.device_get``).  The seeds run one after another; a
        ``mesh`` raises (``MESH_TODO``)."""
        if mesh is not None:
            raise NotImplementedError(MESH_TODO)
        return stack_lanes([to_numpy(self.run(max_ticks, seed=int(s)))
                            for s in seeds])


# Spreading lanes over several cards (the reference's ``shard.py``) is not
# ported: a ``mesh=`` argument raises rather than running on one card.
MESH_TODO = ("mesh= (lanes spread over several cards, the reference's "
             "netsim/shard.py) is not ported yet: ROADMAP.md Queue 1 item 4")


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
    afl = fabric.flags(dims, consts, clock0)
    sfl = sender.flags(dims)

    def arrivals(c, st, k):
        return fabric.arrivals(dims, c, st, k, run=land, fl=afl)
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
                                                          fl=dfl)),
        ("arrivals", arrivals),
        ("control", control),
        ("grants", lambda c, st, k: sender.grants(dims, c, st, k, arb=arb)),
        ("sends", lambda c, st, k: sender.sends(dims, c, st, k, run=send, fl=sfl)),
        ("metrics", lambda c, st, k: metrics.account(dims, c, st, k)),
    )
    return Sim(cfg=cfg, topo=topo, timing=tm, wl=wl, dims=dims, consts=consts,
               device=consts.src.device, phases=phases,
               clock0=clock0, stats={})


def _leap(sim: Sim, st: SimState, now: int, max_ticks: int):
    """Jump ``now`` to the next event horizon, with the closed-form
    occupancy accounting (``metrics.leap_account``).  The horizon stops
    at the fault schedule's next transition (``fabric.horizon``), so no
    leap crosses one.  Returns the state and the leap distance.  A zero
    leap is skipped: it would add ``0 * occupancy = +0.0`` to ``q_sum``,
    which leaves it bitwise unchanged."""
    d = min(int(sim.horizon(st, now)), max_ticks - now)
    if d <= 0:
        return st, 0
    occ = metrics.isum(st.q_size[:-1])
    return st._replace(now=st.now + d,
                       m=metrics.leap_account(st.m, d, occ)), d


def _run_until_done(sim: Sim, st: SimState, max_ticks: int) -> SimState:
    """while(cond) { leap?; K x (cond ? step : stop) } — the reference's
    gated superstep loop (engine.py:223-274).  Once the exit predicate
    holds, the remaining ticks of the superstep are identity, so every K
    gives the K = 1 trajectory."""
    K = max(sim.dims.superstep, 1)
    now = int(st.now)
    finished = bool(st.done.all())
    steps = leaps = 0
    while now < max_ticks and not finished:
        if sim.dims.leap:
            st, d = _leap(sim, st, now, max_ticks)
            now += d
            leaps += d > 0
        for _ in range(K):
            if now >= max_ticks or finished:
                break
            st = sim.step(st, now)
            now += 1
            steps += 1
            finished = bool(st.done.all())        # the tick's one host read
    sim.stats.update(steps=steps, leaps=leaps, ticks=now)
    return st


def _run_trace(sim: Sim, st: SimState, ticks: int, tf: int):
    """The reference's traced scan (engine.py:277-294) as a Python loop.
    Each tick writes its outputs into preallocated tensors on the sim's
    device, so a traced tick reads nothing back to the host.  ``q_mean`` is
    the exact integer sum of the queue sizes times the f32 reciprocal of
    the queue count: XLA compiles the reference's ``jnp.mean`` to that
    product (a divide by a constant becomes a multiply by its reciprocal),
    so this is its value bit for bit, where the IEEE quotient differs by
    an ULP on some ticks."""
    nq, dev = sim.dims.NQ, sim.device
    ncw, ngp = st.cc.cwnd[:tf].shape[0], st.goodput[:tf].shape[0]
    ys = dict(cwnd=torch.empty((ticks, ncw), dtype=F32, device=dev),
              q_mean=torch.empty((ticks,), dtype=F32, device=dev),
              q_max=torch.empty((ticks,), dtype=I32, device=dev),
              delivered=torch.empty((ticks,), dtype=F32, device=dev),
              goodput=torch.empty((ticks, ngp), dtype=I32, device=dev),
              done=torch.empty((ticks,), dtype=I32, device=dev))
    inv_nq = torch.tensor(np.float32(1) / np.float32(nq), dtype=F32, device=dev)
    for t in range(ticks):
        st = sim.step(st, t)
        q = st.q_size[:nq]
        ys["cwnd"][t] = st.cc.cwnd[:tf]
        torch.mul(metrics.isum(q).to(F32), inv_nq, out=ys["q_mean"][t])
        ys["q_max"][t] = torch.max(q)
        ys["delivered"][t] = st.m.delivered_bytes
        ys["goodput"][t] = st.goodput[:tf]
        ys["done"][t] = metrics.isum(st.done)
    sim.stats.update(steps=ticks, leaps=0, ticks=ticks)
    return st, ys
