"""Vectorized, time-stepped packet-level simulator — composition layer.

Execution model (DESIGN.md Sec. 6): one tick = one MTU serialization time;
every output port forwards at most one data packet per tick.  All state is
struct-of-arrays with static shapes; one tick is a pure function
``step: SimState -> SimState`` executed in superstep-fused run loops
(aggregate runs, early exit) or under ``lax.scan`` (trace runs, per-tick
outputs).

The aggregate run loops execute in *supersteps* (DESIGN.md Sec. 6): a
``lax.fori_loop`` fuses ``Dims.superstep`` ticks per ``while_loop``
iteration, amortizing the while-loop round-trip (cond dispatch + carry
handling) over K ticks; each fused tick is individually gated on the same
exit condition (``lax.cond``), keeping every trajectory bit-for-bit
identical to the K=1 loop.  When ``Dims.leap`` holds, each superstep first
applies an *event-horizon time leap* (DESIGN.md Sec. 6.3): a cheap
reduction over the delay rings, armed timers, and admission predicates
yields the distance to the next eventful tick, and ``now`` advances by it
in O(1) — event-free ticks are state no-ops by construction, so the
leap-on trajectory stays bit-for-bit equal to leap-off.  All run-loop
entry points donate the incoming ``SimState`` buffers to XLA (callers
must treat a state passed to a run loop as consumed).

The six sub-steps of a tick live in dedicated phase modules, each a pure
function ``(Dims, Consts, SimState) -> SimState``:

  1. departures : ``fabric.departures``  (dequeue, RED mark, route, wire)
  2. arrivals   : ``fabric.arrivals``    (enqueue/trim/drop or deliver/ACK)
  3. control    : ``transport.control``  (ACK/trim/timeout -> CC + LB)
  4. grants     : ``sender.grants``      (EQDS pull credits)
  5. sends      : ``sender.sends``       (arbitration, admission, emission)
  6. metrics    : ``metrics.account``    (occupancy/rate accounting)

``build`` resolves the CC algorithm to a backend-qualified update function
(``cc_backend="jnp"`` pure jnp, or ``"pallas"`` for the ``kernels/
cc_update`` kernel) — and, the same way, the fabric's fused
enqueue-rank/arbitration pair (``fabric_backend`` ->
``kernels/enqueue_arb``) and the transport's packed sent-ring drain
(``transport_backend`` -> ``kernels/ring_drain``); every backend pair is
bit-for-bit interchangeable (DESIGN.md Sec. 6.4).  The phases compose
over a ``Consts`` bundle of traced numerics — so retuning any parameter,
or sweeping a whole grid of them, reuses one compiled step.

In the benchmark's reference this module is the JAX package's engine on
NumPy (``np32``): one lane at a time, the loops run in Python, no batch
and no trace runs; :func:`run_lane` at the end is the benchmark's entry.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from . import np32 as jax
from . import np32 as jnp

from . import registry, reps
from .cctypes import CCParams
from . import enqueue_arb_ops
from . import ring_drain_ops
from . import fabric, metrics, sender, transport
from .metrics import HIST_BINS, jain_fairness, summarize  # noqa: F401 (re-export)
from .state import (Consts, Dims, SimConfig, SimState,  # noqa: F401
                                derive, init_state)
from .topology import Topology
from .units import Timing
from .workloads import Workload

I32 = jnp.int32
F32 = jnp.float32

# Incremented each time a composed step function is *traced* (not executed).
# ``tests/test_sweep.py`` asserts a whole parameter grid costs exactly one:
# ``with trace_guard("engine.step", expect=1): ...`` (repro.analysis).


@dataclasses.dataclass(frozen=True)
class Sim:
    """Compiled simulator bundle."""

    cfg: SimConfig
    topo: Topology
    timing: Timing
    wl: Workload
    cc_params: CCParams
    lb_params: reps.LBParams
    dims: Dims
    consts: Consts
    phases: tuple           # ordered ((name, (Consts, SimState) -> SimState),
                            #   ...) — the six tick sub-steps step_fn composes;
                            # the phase profiler (benchmarks/profile_tick) and
                            # the jaxpr auditor (repro.analysis.audit) walk
                            # these so their phase split can never drift from
                            # the real tick
    step_fn: callable       # (Consts, SimState) -> SimState — sweepable form
    step: callable          # SimState -> SimState (consts bound)
    horizon_fn: callable    # (Consts, SimState) -> i32 next-event distance
    horizon: callable       # SimState -> i32 (consts bound)
    init: callable          # () -> SimState

    def _leap_horizon(self):
        return self.horizon if self.dims.leap else None

    def run(self, max_ticks: int, seed: int = 0) -> SimState:
        """Run to completion.  ``seed`` sets the per-run hash salt
        (RED/ECMP decorrelation) — seed 0 is the historical default."""
        st0 = self.init()
        if seed:
            st0 = st0._replace(salt=jnp.asarray(seed, I32))
        return _run_until_done(self.step, self._leap_horizon(), st0,
                               max_ticks, self.dims.superstep)


# --------------------------------------------------------------------------
# build
# --------------------------------------------------------------------------


def build(cfg: SimConfig, wl: Workload) -> Sim:
    topo, tm, dims, consts = derive(cfg, wl)
    cc_update = registry.get(cfg.algo, cfg.cc_backend)
    # fabric/transport hot-loop backends, resolved once like cc_update:
    # enqueue-rank + round-robin arbitration (kernels/enqueue_arb) and the
    # packed sent-ring drain (kernels/ring_drain) — "jnp" is the reference
    # vector program, "pallas" the bit-identical blocked kernel
    enqueue, arb = enqueue_arb_ops.get(cfg.fabric_backend)
    drain = ring_drain_ops.get(cfg.transport_backend)

    phases = (
        ("departures", lambda c, st: fabric.departures(dims, c, st)),
        ("arrivals", lambda c, st: fabric.arrivals(dims, c, st,
                                                   enqueue=enqueue)),
        ("control", lambda c, st: transport.control(dims, c, cc_update, st,
                                                    drain=drain)),
        ("grants", lambda c, st: sender.grants(dims, c, st, arb=arb)),
        ("sends", lambda c, st: sender.sends(dims, c, st, arb=arb)),
        ("metrics", lambda c, st: metrics.account(dims, c, st)),
    )

    def step_fn(consts: Consts, st: SimState) -> SimState:
        for _, phase in phases:
            st = phase(consts, st)
        return st._replace(now=st.now + 1)

    def step(st: SimState) -> SimState:
        return step_fn(consts, st)

    def horizon_fn(consts: Consts, st: SimState):
        """Distance (ticks) to the next eventful tick — min over the
        per-phase next-event reductions (DESIGN.md Sec. 6.3)."""
        h = fabric.horizon(dims, consts, st)
        h = jnp.minimum(h, transport.horizon(dims, consts, st))
        return jnp.minimum(h, sender.horizon(dims, consts, st))

    def horizon(st: SimState):
        return horizon_fn(consts, st)

    def init() -> SimState:
        return init_state(dims, consts)

    return Sim(cfg=cfg, topo=topo, timing=tm, wl=wl, cc_params=consts.cc,
               lb_params=consts.lb, dims=dims, consts=consts, phases=phases,
               step_fn=step_fn, step=step, horizon_fn=horizon_fn,
               horizon=horizon, init=init)


# --------------------------------------------------------------------------
# run loops (superstep execution; donated state buffers)
# --------------------------------------------------------------------------
#
# The outer while loop advances one *superstep* (K fused ticks) per
# iteration, amortizing the loop round-trip over K ticks.  Each fused tick
# is gated on the *same* exit predicate via ``lax.cond`` (so the cheap
# reduction still runs per tick, but as part of the fused body) — the
# predicate is scalar (reduced over flows; the api lane loop additionally
# gates each lane on its own predicate) so the cond stays a real branch,
# and once the run
# finishes or hits max_ticks the remaining ticks of the superstep are
# identity — which makes every K > 1 trajectory bit-for-bit identical to
# K = 1, including ``now`` and all metrics counters (asserted in
# tests/test_engine_superstep.py).
#
# ``donate_argnums`` hands the incoming state's buffers to XLA for in-place
# reuse as the loop carry.  Contract: a ``SimState`` passed to a run loop
# is consumed — callers must not read it afterwards (all entry points here
# build a fresh ``init()`` per call).


def _superstep_loop(step, cond, K, leap=None):
    """while(cond) { leap?; K x (cond ? step : id) } — cond reduced once
    per K.

    Every K (including 1) uses the same gated fori-in-while structure, so
    the tick graph is embedded — and therefore lowered by XLA — identically
    for every superstep size; only the trip count changes.  (Embedding the
    K=1 tick bare in the while body changes XLA's fusion/FMA-contraction
    decisions and perturbs f32 CC arithmetic by an ULP, which would break
    the bit-for-bit equivalence contract across K.)

    ``leap``, when given, runs once per superstep before the fused ticks:
    it advances ``now`` to the next event horizon in O(1) (DESIGN.md Sec.
    6.3).  The leap lands *at or before* the next eventful tick and the
    leap distance is clamped to the remaining tick budget, so the gated
    ticks that follow execute exactly the eventful ticks (plus event-free
    ticks, which are state no-ops) of the leap-free trajectory."""
    def tick(_, st):
        return jax.lax.cond(cond(st), step, lambda s: s, st)

    def body(st):
        if leap is not None:
            st = leap(st)
        return jax.lax.fori_loop(0, max(K, 1), tick, st)

    return lambda st: jax.lax.while_loop(cond, body, st)


def _leap(horizon, max_ticks):
    """Single-run time leap: jump ``now`` to the next event horizon and
    apply the closed-form Δ-tick accounting (``metrics.leap_account``).

    Today's leap predicate only jumps with every queue empty, so the
    occupancy integral provably contributes 0.0 — the general Δ * Σq form
    is kept so a relaxed predicate (e.g. leaping a degraded link's idle
    service periods with packets parked) inherits correct accounting."""
    def leap(st):
        d = jnp.minimum(horizon(st), max_ticks - st.now)
        occ = jnp.sum(st.q_size[:-1])
        return st._replace(now=st.now + d,
                           m=metrics.leap_account(st.m, d, occ))
    return leap


@functools.partial(jax.jit, static_argnums=(0, 1, 3, 4), donate_argnums=(2,))
def _run_until_done(step, horizon, state0: SimState, max_ticks: int,
                    superstep: int) -> SimState:
    def cond(st):
        return (st.now < max_ticks) & ~jnp.all(st.done)

    leap = _leap(horizon, max_ticks) if horizon is not None else None
    return _superstep_loop(step, cond, superstep, leap)(state0)


# --------------------------------------------------------------------------
# the benchmark's entry: one lane of a sweep point and a salt
# --------------------------------------------------------------------------

# sweep-point keys: make_cc_params tuning kwargs (through
# SimConfig.cc_overrides) and numeric SimConfig fields
CC_PARAM_KEYS = frozenset({
    "target_mult", "fd", "md", "fi", "k_fast", "qa_scaling", "wtd_alpha",
    "wtd_thresh", "fi_rtt_tol", "maxcwnd_mult", "sw_ai", "sw_beta",
    "sw_max_mdf",
})
CFG_KEYS = frozenset({
    "rto_mult", "react_every", "credit_window_mult", "start_cwnd_mult",
    "kmin_frac", "kmax_frac", "num_entropies", "fault_start",
    "goodput_bin",
})


def apply_point(cfg: SimConfig, point) -> SimConfig:
    """Fold one sweep point into a SimConfig (cc keys -> cc_overrides)."""
    cfg_kw, cc = {}, dict(cfg.cc_overrides)
    for k, v in dict(point).items():
        if k in CFG_KEYS:
            cfg_kw[k] = v
        elif k in CC_PARAM_KEYS:
            cc[k] = v
        else:
            raise KeyError(f"unsweepable key {k!r}")
    return dataclasses.replace(cfg, cc_overrides=tuple(sorted(cc.items())), **cfg_kw)


def bfloat16(x):
    """``x`` (float32) rounded to the nearest bfloat16, to nearest even,
    and held as float32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return jnp.asarray(u.astype(np.uint32).view(np.float32))


def with_cc_precision(sim: Sim, rounding) -> Sim:
    """``sim`` with every float32 leaf of the congestion state passed
    through ``rounding`` after each tick's control phase: the benchmark's
    control, the reference one precision below the configuration's."""
    def rounded(phase):
        def f(c, st):
            st = phase(c, st)
            cc = type(st.cc)(*(rounding(x) if np.asarray(x).dtype == np.float32 else x
                               for x in st.cc))
            return st._replace(cc=cc)
        return f

    phases = tuple((n, rounded(p) if n == "control" else p) for n, p in sim.phases)

    def step_fn(consts, st):
        for _, phase in phases:
            st = phase(consts, st)
        return st._replace(now=st.now + 1)

    return dataclasses.replace(sim, phases=phases, step_fn=step_fn,
                               step=lambda st: step_fn(sim.consts, st))


def run_lane(cfg: SimConfig, wl: Workload, point, salt: int, max_ticks: int,
             cc_precision: str | None = None) -> tuple:
    """``(final state with numpy leaves, simulator)`` of one lane: the
    point folded into ``cfg``, the hash salt ``salt``, to completion or
    ``max_ticks``; ``cc_precision`` ``"bfloat16"`` runs the control."""
    sim = build(apply_point(cfg, point), wl)
    if cc_precision == "bfloat16":
        sim = with_cc_precision(sim, bfloat16)
    elif cc_precision is not None:
        raise ValueError(f"no control precision {cc_precision!r}")
    st = sim.run(max_ticks, seed=int(salt))
    return tree_numpy(st), sim


def tree_numpy(tree):
    """A NamedTuple state with plain numpy leaves."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_numpy(x) for x in tree))
    return np.array(tree, copy=True).view(np.ndarray)
