"""Time-stepped packet-level simulator — composition layer and run loop.

Execution model (DESIGN.md Sec. 6): one tick = one MTU serialization time;
every output port forwards at most one data packet per tick.  All state is
struct-of-arrays tensors on one device; a tick is the composition of six
phases, each ``(Dims, Consts, SimState, Clock) -> SimState``:

  1. departures : ``fabric.departures``  (dequeue, RED mark, route, wire)
  2. arrivals   : ``fabric.arrivals``    (enqueue/trim/drop or deliver/ACK)
  3. control    : ``transport.control``  (ACK/trim/timeout -> CC + LB)
  4. grants     : ``sender.grants``      (EQDS pull credits; SMaRTT: none)
  5. sends      : ``sender.sends``       (arbitration, admission, emission)
  6. metrics    : ``metrics.account``    (occupancy accounting)

``build`` resolves the backends once, as the reference does: the CC update
(``cc_backend``), the enqueue-rank/arbitration pair (``fabric_backend``)
and the sent-ring drain (``transport_backend``).  ``"kernel"`` (the
default) launches the hand-written CUDA kernels on the card and takes
their plain versions on the CPU; ``"plain"`` takes the plain versions
everywhere.

The run loop is the reference's gated superstep loop written as a Python
loop: each superstep first leaps ``now`` to the next event horizon (one
host read of the horizon, DESIGN.md Sec. 6.3), then runs up to K ticks,
each gated on the exit predicate (one host read a tick).  Leap-on equals
leap-off and every K equals K = 1 over the whole state, as in the
reference.  The host keeps the tick ``t`` itself (``state.Clock``), so no
phase waits on the device to address a ring.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import registry
from repro_torch.kernels.enqueue_arb import ops as enqueue_arb_ops
from repro_torch.kernels.ring_drain import ops as ring_drain_ops
from repro_torch.netsim import fabric, metrics, sender, transport
from repro_torch.netsim.metrics import HIST_BINS, jain_fairness, summarize  # noqa: F401
from repro_torch.netsim.state import (Clock, Consts, Dims, SimConfig,  # noqa: F401
                                      SimState, clock, derive, init_state)
from repro_torch.netsim.topology import Topology
from repro_torch.netsim.units import Timing
from repro_torch.netsim.workloads import Workload

I32 = torch.int32


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


def build(cfg: SimConfig, wl: Workload, device="cuda") -> Sim:
    """Derive the tables on ``device`` and compose the tick.  The card is
    the default; ``device="cpu"`` runs the plain versions on the CPU."""
    cc_update = registry.get(cfg.algo, cfg.cc_backend)
    enqueue, arb = enqueue_arb_ops.get(cfg.fabric_backend)
    drain = ring_drain_ops.get(cfg.transport_backend)
    topo, tm, dims, consts = derive(cfg, wl, device)

    phases = (
        ("departures", lambda c, st, k: fabric.departures(dims, c, st, k)),
        ("arrivals", lambda c, st, k: fabric.arrivals(dims, c, st, k,
                                                      enqueue=enqueue)),
        ("control", lambda c, st, k: transport.control(dims, c, cc_update, st,
                                                       k, drain=drain)),
        ("grants", lambda c, st, k: sender.grants(dims, c, st, k)),
        ("sends", lambda c, st, k: sender.sends(dims, c, st, k, arb=arb)),
        ("metrics", lambda c, st, k: metrics.account(dims, c, st, k)),
    )
    return Sim(cfg=cfg, topo=topo, timing=tm, wl=wl, dims=dims, consts=consts,
               device=consts.src.device, phases=phases,
               clock0=clock(consts), stats={})


def _leap(sim: Sim, st: SimState, now: int, max_ticks: int):
    """Jump ``now`` to the next event horizon, with the closed-form
    occupancy accounting (``metrics.leap_account``).  Returns the state
    and the leap distance.  A zero leap is skipped: it would add
    ``0 * occupancy = +0.0`` to ``q_sum``, which leaves it bitwise
    unchanged."""
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
