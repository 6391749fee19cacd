"""The lane loop: a study's lanes as one batch on one card (DESIGN.md Sec. 7).

The experiment API lowers a ``Scenario x points x seeds`` grid onto one
``[B = P*S]`` lane batch (``netsim/api.py``).  This module is the
executor under it, the reference's ``netsim/shard.py`` on one device:

* ``lane_loop``   the per-lane gated, per-lane leaping superstep loop
                  over a lane batch: one launch of each fused tick kernel
                  a batched tick, for all live lanes;
* ``lane_mesh``   the devices a batch could spread over (a list of
                  ``torch.device``);
* ``pad_lanes``   pads a batch to a multiple with *frozen* lanes (copies
                  of the last lane with every flow done: the lane gate
                  makes them bitwise no-ops from tick 0);
* ``run_lanes``   the one entry point.  A mesh of one device runs the
                  single-device loop, as in the reference; spreading the
                  lanes over several cards is not ported and raises
                  (``engine.MESH_TODO``).

Each lane is gated on its *own* exit predicate, ``live = (now <
max_ticks) & ~all(done)``, computed on the device each tick: a lane that
is not live is a bitwise no-op (its kernels return at once, the tick's
PyTorch writes it nowhere), while the rest keep stepping.  With leaping
on, each lane leaps by its own next-event distance under its own swept
constants, clamped to its remaining budget and zero once it is done.  The
superstep structure (leap once, then K gated ticks) is the standalone
loop's, so every lane's final state equals its standalone ``Sim.run``
bit for bit, ``now`` included (a lane's trajectory does not depend on
the batch it runs in).

The host keeps a copy of each lane's tick and gate (the plain versions
read them): it reads the ``[L]`` gate once a tick and the ``[L]`` leap
once a superstep, as the standalone loop reads its exit test and its
horizon.  The incoming state batch is consumed (updated in place).
"""

from __future__ import annotations

import torch

from repro_torch.analysis.trace_guard import counter
from repro_torch.kernels.lanes import Tick
from repro_torch.netsim import engine, metrics, state

# Counts entries of ``lane_loop``: the reference's ``"engine.step"`` trace
# counter (``with trace_guard("shard.lane_loop", expect=1): study.run()``).
_LOOPS = counter("shard.lane_loop")


def lane_loop(sim, consts_b, axes, max_ticks: int):
    """The lane batch run loop as a function ``states -> states`` (each
    lane's final state).  ``consts_b``/``axes`` are the batch's constants
    (``axes=None``: the sim's own, shared by every lane).  Sets
    ``sim.stats``: lane 0's ``steps``/``leaps``/``ticks`` (a one-lane
    batch is ``Sim.run``) and ``lanes``, every lane's and the batched
    ticks (``batch_ticks``: one launch of each fused kernel each)."""
    _LOOPS.hit()
    K = max(sim.dims.superstep, 1)

    def run(st: state.SimState) -> state.SimState:
        n = int(st.now.shape[0])
        c = sim.lanes_of(consts_b, n, axes)
        now_h = st.now.tolist()
        live = (st.now < max_ticks) & ~torch.all(st.done, dim=-1)
        live_h = live.tolist()
        steps, leaps, batch = [0] * n, [0] * n, 0
        while any(live_h):
            if sim.dims.leap:
                h = sim.horizon_lanes(c, st, st.now[:, None])
                d = torch.where(live, torch.minimum(h, max_ticks - st.now),
                                0).to(torch.int32)
                d_h = d.tolist()                    # the superstep's host read
                if any(x > 0 for x in d_h):
                    occ = metrics.isum(st.q_size[:, :-1], -1)
                    st = st._replace(now=st.now + d, m=metrics.leap_account(st.m, d, occ))
                    now_h = [a + b for a, b in zip(now_h, d_h)]
                    leaps = [a + (b > 0) for a, b in zip(leaps, d_h)]
                    live = live & (st.now < max_ticks)
                    live_h = [g and t < max_ticks for g, t in zip(live_h, now_h)]
            for _ in range(K):
                if not any(live_h):
                    break
                st = sim.tick(c, st, Tick(st.now, live, tuple(now_h), tuple(live_h)))
                batch += 1
                now_h = [t + g for t, g in zip(now_h, live_h)]
                steps = [s + g for s, g in zip(steps, live_h)]
                live = ~torch.all(st.done, dim=-1)
                if not all(t < max_ticks for t in now_h):
                    live = live & (st.now < max_ticks)
                live_h = live.tolist()              # the tick's one host read
        sim.stats.update(steps=steps[0], leaps=leaps[0], ticks=now_h[0],
                         lanes=dict(steps=steps, leaps=leaps, ticks=now_h,
                                    batch_ticks=batch))
        return st

    return run


def _run_lanes(sim, consts_b, axes, states: state.SimState,
               max_ticks: int) -> state.SimState:
    """Single-device execution of :func:`lane_loop`."""
    return lane_loop(sim, consts_b, axes, int(max_ticks))(states)


def lane_mesh(devices=None) -> list:
    """The devices a lane batch could spread over (default: every visible
    card, else the CPU), as a list of ``torch.device``."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def axes_leaves(axes) -> list:
    """The axes tree's leaves (0 / None), aligned with
    ``state.tree_leaves`` of the matching constants."""
    return state.tree_leaves(axes)


def pad_lanes(states: state.SimState, consts_b, axes, mult: int):
    """Pad a ``[B]`` lane batch (and the swept constants) to the next
    multiple of ``mult``.  Pad lanes are copies of the last real lane with
    every flow marked ``done``: the lane gate freezes them from tick 0, so
    they are bit-inert ballast, sliced off by the caller after the run.
    Returns ``(states, consts_b, n_pad)``."""
    B = int(states.now.shape[0])
    n_pad = (-B) % max(int(mult), 1)
    if n_pad == 0:
        return states, consts_b, 0

    def pad(x):
        return torch.cat([x, x[-1:].expand((n_pad,) + tuple(x.shape[1:]))], dim=0)

    states = state.tree_map(pad, states)
    states.done[B:] = True
    if axes is not None:
        consts_b = state.tree_map(lambda x, a: pad(x) if a == 0 else x, consts_b, axes)
    return states, consts_b, n_pad


def run_lanes(sim, consts_b, axes, states: state.SimState, max_ticks: int,
              mesh=None) -> state.SimState:
    """Run a ``[B]`` lane batch to completion — THE batched run loop behind
    ``Study``, ``Sim.run_batch`` and ``Sweep.run``.

    ``mesh=None`` or a mesh of one device (``lane_mesh``) is the
    single-device path.  A larger mesh raises ``NotImplementedError``
    (``engine.MESH_TODO``): lanes over several cards are not ported."""
    if mesh is not None:
        devs = list(mesh) if isinstance(mesh, (list, tuple)) else None
        if devs is None or len(devs) != 1:
            raise NotImplementedError(engine.MESH_TODO)
        if torch.device(devs[0]).type != sim.device.type:
            raise ValueError(f"a one-device mesh on {devs[0]} for a simulator on "
                             f"{sim.device}")
    return _run_lanes(sim, consts_b, axes, states, max_ticks)
