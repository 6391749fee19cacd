"""The lane loop, and a lane batch spread over a mesh of devices (DESIGN.md Sec. 7).

The experiment API lowers a ``Scenario x points x seeds`` grid onto one
``[B = P*S]`` lane batch (``netsim/api.py``).  This module is the
executor under it, the reference's ``netsim/shard.py``:

* ``lane_loop``   the per-lane gated, per-lane leaping superstep loop
                  over a lane batch: one launch of each fused tick kernel
                  a batched tick, for all live lanes;
* ``lane_mesh``   the devices a batch spreads over (a list of
                  ``torch.device``; default: every visible card);
* ``pad_lanes``   pads a batch to a multiple with *frozen* lanes (copies
                  of the last lane with every flow done: the lane gate
                  makes them bitwise no-ops from tick 0);
* ``run_lanes``   the one entry point: one loop on one device, or one
                  loop a shard over a mesh.

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

Over a mesh of ``D > 1`` devices the reference's ``shard_map`` semantics
hold: the batch is padded to a multiple of ``D``, each device takes a
contiguous block of ``B/D`` lanes (swept constants go with their lanes,
shared ones are copied to each shard's device) and runs its own lane
loop, with its own gate, leap and superstep cadence, so a shard whose
lanes finish stops.  The blocks come back to the simulator's device in
lane order, sliced to ``[B]``: bit-equal to the one-device batch.  Each
shard runs on a host thread of its own, on a CUDA stream of its own on
its device, so shards are ordered independently, as on distinct cards;
a lock shared by the shards lets one thread at a time issue a tick's
host work, while the others wait on their devices.
A device may appear more than once: the CPU is one device to torch, so
``["cpu"] * 4`` is the CPU's mesh (as the reference's tests force four
host devices), and ``[cuda:0] * 2`` runs the path on one card.  That is
a rehearsal of the path on one card, not a measurement of several.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.analysis.trace_guard import counter, span
from repro_torch.kernels import build
from repro_torch.kernels.lanes import Tick
from repro_torch.netsim import engine, metrics, state

# Counts entries of ``lane_loop``: the reference's ``"engine.step"`` trace
# counter (``with trace_guard("shard.lane_loop", expect=1): study.run()``).
# A run over a mesh counts one, as the reference's shard_map traces its
# body once.
_LOOPS = counter("shard.lane_loop")


def lane_loop(sim, consts_b, axes, max_ticks: int):
    """The lane batch run loop as a function ``states -> states`` (each
    lane's final state).  ``consts_b``/``axes`` are the batch's constants
    (``axes=None``: the sim's own, shared by every lane).  Sets
    ``sim.stats``: lane 0's ``steps``/``leaps``/``ticks`` (a one-lane
    batch is ``Sim.run``) and ``lanes``, every lane's and the batched
    ticks (``batch_ticks``: one launch of each fused kernel each;
    ``shard_ticks``, each shard's, here the one)."""
    _LOOPS.hit()
    return _loop(sim, consts_b, axes, max_ticks)


def _loop(sim, consts_b, axes, max_ticks: int, host=None):
    """:func:`lane_loop` without its count: a shard's loop.  ``host`` (a
    lock shared by the shards of one run) is held for the host's work of a
    tick or a leap and let go for the host reads that wait on the device,
    so that one shard's thread issues its tick while the others wait on
    theirs: the threads take turns at the interpreter a tick at a time
    instead of an operation at a time.  The loop's span (``lanes.loop``)
    counts its batched ticks and lane-ticks."""
    K = max(sim.dims.superstep, 1)
    host = contextlib.nullcontext() if host is None else host

    def loop(st: state.SimState) -> state.SimState:
        n = int(st.now.shape[0])
        with host:
            c = sim.lanes_of(consts_b, n, axes)
            live = (st.now < max_ticks) & ~torch.all(st.done, dim=-1)
        with span("lanes.gate_read"):
            now_h = st.now.tolist()
            live_h = live.tolist()
        steps, leaps, batch = [0] * n, [0] * n, 0
        while any(live_h):
            if sim.dims.leap:
                with span("lanes.leap"):
                    with host:
                        h = sim.horizon_lanes(c, st, st.now[:, None])
                        d = torch.where(live, torch.minimum(h, max_ticks - st.now),
                                        0).to(torch.int32)
                    with span("lanes.leap_read"):
                        d_h = d.tolist()            # the superstep's host read
                    if any(x > 0 for x in d_h):
                        with host:
                            occ = metrics.isum(st.q_size[:, :-1], -1)
                            st = st._replace(now=st.now + d,
                                             m=metrics.leap_account(st.m, d, occ))
                            live = live & (st.now < max_ticks)
                        now_h = [a + b for a, b in zip(now_h, d_h)]
                        leaps = [a + (b > 0) for a, b in zip(leaps, d_h)]
                        live_h = [g and t < max_ticks for g, t in zip(live_h, now_h)]
            for _ in range(K):
                if not any(live_h):
                    break
                with host:
                    st = sim.tick(c, st, Tick(st.now, live, tuple(now_h), tuple(live_h)))
                    now_h = [t + g for t, g in zip(now_h, live_h)]
                    live = ~torch.all(st.done, dim=-1)
                    if not all(t < max_ticks for t in now_h):
                        live = live & (st.now < max_ticks)
                batch += 1
                steps = [s + g for s, g in zip(steps, live_h)]
                with span("lanes.gate_read"):
                    live_h = live.tolist()          # the tick's one host read
        sim.stats.update(steps=steps[0], leaps=leaps[0], ticks=now_h[0],
                         lanes=dict(steps=steps, leaps=leaps, ticks=now_h,
                                    batch_ticks=batch, shard_ticks=[batch]))
        return st

    def run(st: state.SimState) -> state.SimState:
        with span("lanes.loop") as sp:
            st = loop(st)
            lanes = sim.stats["lanes"]
            sp.count(batch_ticks=lanes["batch_ticks"], lane_ticks=sum(lanes["steps"]))
        return st

    return run


def _run_lanes(sim, consts_b, axes, states: state.SimState,
               max_ticks: int) -> state.SimState:
    """Single-device execution of :func:`lane_loop`."""
    return lane_loop(sim, consts_b, axes, int(max_ticks))(states)


def lane_mesh(devices=None) -> list:
    """The devices a lane batch spreads over, as a list of ``torch.device``:
    ``devices`` as given (a device may repeat: ``["cpu"] * 4`` is the
    CPU's mesh), or every visible card.  Without a card and without
    ``devices`` it raises: a caller who wants the CPU names it."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError("lane_mesh(): torch.cuda.is_available() is False; name the "
                           "devices (lane_mesh(['cpu'] * 4)) to spread lanes on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


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


def _mesh_devices(sim, mesh) -> list:
    """``mesh`` as a list of devices of the simulator's type (a card
    without an index is the current one); raises for anything else."""
    if not isinstance(mesh, (list, tuple)):
        raise TypeError(f"mesh: a list of devices (shard.lane_mesh()), got "
                        f"{type(mesh).__name__}")
    if not mesh:
        raise ValueError("mesh: an empty list of devices")
    devs = []
    for d in mesh:
        try:
            dev = torch.device(d)
        except (TypeError, RuntimeError) as e:
            raise TypeError(f"mesh: {d!r} is not a device") from e
        if dev.type != sim.device.type:
            raise ValueError(f"mesh: {dev} for a simulator on {sim.device}")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        devs.append(dev)
    return devs


def _shard_sim(sim, dev):
    """A simulator for one shard on ``dev``: the sim's tick, with stats and
    caches of its own (each shard's lane constants and counts), its
    constants on ``dev``.  A device other than the sim's own is built
    once and kept in ``sim.cache``."""
    base = sim
    if dev != sim.device:
        key = ("shard_sim", str(dev))
        if key not in sim.cache:
            sim.cache[key] = engine.build(sim.cfg, sim.wl, device=dev)
        base = sim.cache[key]
    return dataclasses.replace(base, stats={}, cache={})


def _to(x, dev):
    return x.to(dev) if isinstance(x, torch.Tensor) and x.device != dev else x


def _run_sharded(sim, consts_b, axes, states: state.SimState, max_ticks: int,
                 devs: list) -> state.SimState:
    """One lane loop a shard over ``devs``, each on a thread of its own (on
    a card, on a stream of its own), the result gathered on the sim's
    device in lane order and sliced back to ``[B]``."""
    engine.check_lane_backends(sim.cfg)
    _LOOPS.hit()
    B, D = int(states.now.shape[0]), len(devs)
    states, consts_p, _ = pad_lanes(states, consts_b, axes, D)
    per = int(states.now.shape[0]) // D
    cuda = sim.device.type == "cuda"
    if cuda:
        build.library()              # the first load, before the shards' threads
    shards = []
    for i, dev in enumerate(devs):
        s = _shard_sim(sim, dev)
        lanes = slice(i * per, (i + 1) * per)
        st = state.tree_map(lambda x: _to(x[lanes], dev), states)
        if axes is None:
            cb = s.consts
        else:
            cb = state.tree_map(lambda x, a: _to(x[lanes] if a == 0 else x, dev),
                                consts_p, axes)
        shards.append((s, cb, st))
    streams = [torch.cuda.Stream(device=d) for d in devs] if cuda else [None] * D
    for stream, dev in zip(streams, devs):
        if stream is not None:       # the inputs were made on the caller's streams
            stream.wait_stream(torch.cuda.current_stream(dev))

    host = threading.Lock()

    def run(i):
        s, cb, st = shards[i]
        with span("lanes.shard", shard=i):          # the root of the thread's spans
            if streams[i] is None:
                return _loop(s, cb, axes, max_ticks, host)(st)
            with torch.cuda.device(devs[i]), torch.cuda.stream(streams[i]):
                return _loop(s, cb, axes, max_ticks, host)(st)

    with ThreadPoolExecutor(max_workers=D, thread_name_prefix="lanes") as pool:
        futures = [pool.submit(run, i) for i in range(D)]
    outs = [f.result() for f in futures]            # a shard that raised raises here
    if cuda:
        here = torch.cuda.current_stream(sim.device)
        for stream, dev, out in zip(streams, devs, outs):
            here.wait_stream(stream)
            torch.cuda.current_stream(dev).wait_stream(stream)
            for x in state.tree_leaves(out):
                x.record_stream(torch.cuda.current_stream(dev))
                x.record_stream(here)
    out = state.tree_map(lambda *xs: torch.cat([_to(x, sim.device) for x in xs])[:B],
                         *outs)
    lane_stats = [s.stats["lanes"] for s, _, _ in shards]
    steps, leaps, ticks = ([x for ls in lane_stats for x in ls[k]][:B]
                           for k in ("steps", "leaps", "ticks"))
    shard_ticks = [ls["batch_ticks"] for ls in lane_stats]
    sim.stats.update(steps=steps[0], leaps=leaps[0], ticks=ticks[0],
                     lanes=dict(steps=steps, leaps=leaps, ticks=ticks,
                                batch_ticks=sum(shard_ticks), shard_ticks=shard_ticks))
    return out


def run_lanes(sim, consts_b, axes, states: state.SimState, max_ticks: int,
              mesh=None) -> state.SimState:
    """Run a ``[B]`` lane batch to completion — THE batched run loop behind
    ``Study``, ``Sim.run_batch`` and ``Sweep.run``.

    ``mesh=None`` or a mesh of one device (``lane_mesh``) is the
    single-device path.  A larger mesh pads the batch to a multiple of
    its size, runs one lane loop a shard (module docstring) and returns
    the ``[B]`` batch on the sim's device, bit-equal to the single-device
    path.  ``sim.stats["lanes"]`` then holds every real lane's counts in
    lane order and each shard's batched ticks (``shard_ticks``; each
    fused kernel launches ``batch_ticks``, their sum, times).  A mesh that
    is not a list of devices of the sim's type raises, as does an earlier
    design's one-lane backend (``engine.check_lane_backends``); so does a
    shard whose thread raised."""
    if mesh is not None:
        devs = _mesh_devices(sim, mesh)
        if len(devs) > 1:
            return _run_sharded(sim, consts_b, axes, states, int(max_ticks), devs)
    return _run_lanes(sim, consts_b, axes, states, max_ticks)
