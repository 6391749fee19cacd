"""PyTorch port, the span recorder (``repro_torch.analysis.trace_guard``:
``span``, ``recording``, ``profiled``) and the spans at the simulator's
layer boundaries (``study.*`` in ``netsim/api.py``, ``lanes.*`` in
``netsim/shard.py``, ``tick.*`` in ``Sim.tick``), on the CPU: off, a study
records nothing and ``span`` allocates nothing; on, a tiny-tree study's
spans nest as the layers do, each batched tick has its six phases and one
gate read, the loop's counts are the lane counts, and the study's states
and rows are bit-equal to an unrecorded one; over a mesh each shard's
spans nest within its own thread; under EQDS three spans split each
``tick.grants`` (none under SMaRTT); the anchor puts the spans on the clock
of torch.profiler's events, and a study under a profiler session records
itself.  The card's test (``gpu``) holds a span to the device interval of
the fused kernels it launched."""

import itertools
import threading
import tracemalloc
from collections import Counter

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.trace_guard import (NO_SPAN, last_profiled, profiled,  # noqa: E402
                                              recording, span)
from repro_torch.netsim import api, engine, state  # noqa: E402

CPU = "cpu"
POINTS = ({}, {"start_cwnd_mult": 0.5})
SEEDS = (0, 1)
CHILDREN = {
    "study.run": {"study.init", "lanes.loop", "study.host_copy", "study.results"},
    "lanes.loop": {"lanes.gate_read", "lanes.leap", *engine.TICK_SPANS.values()},
    "lanes.leap": {"lanes.leap_read"},
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, as ``test_torch_engine.one_torch_thread`` (this
    file imports no JAX, so that its card test runs on the card's
    machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _study(**kw):
    return api.study("tiny_3t", points=POINTS, seeds=SEEDS, device=CPU, **kw)


def _assert_results_equal(a, b):
    la, lb = state.tree_leaves(a.states), state.tree_leaves(b.states)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    assert a.rows() == b.rows()


@pytest.fixture(scope="module")
def recorded():
    """One study of the tiny tree unrecorded, then one recorded: ``(result
    off, result on, the study, its recording's rows)``."""
    off = _study().run()
    with recording() as rec:
        plan = _study()
        on = plan.run()
    return off, on, plan, rec.rows()


def test_off_records_nothing():
    before = last_profiled()
    assert span("tick.departures") is NO_SPAN
    with span("lanes.loop", batch_ticks=1) as sp:
        sp.count(lane_ticks=2)
    plan = _study()
    plan.run()
    assert plan.recording is None and last_profiled() is before
    with profiled() as rec:
        assert rec is None              # no profiler session: nothing opens


def _no_span(name):
    return NO_SPAN


def _traced_bytes(fn, n: int) -> tuple:
    """(bytes still held, peak bytes) that ``n`` spans made by ``fn`` left
    and reached, as tracemalloc sees them."""
    def loop(k):
        for _ in itertools.repeat(None, k):
            with fn("tick.departures"):
                pass
    loop(1)
    tracemalloc.reset_peak()
    held, _ = tracemalloc.get_traced_memory()
    loop(n)
    now, peak = tracemalloc.get_traced_memory()
    return now - held, peak - held


def test_span_off_allocates_nothing():
    """Off, ``span`` costs what a call returning a constant costs: no
    allocation the allocator sees, however many spans."""
    tracemalloc.start()
    try:
        plain = _traced_bytes(_no_span, 10_000)
        assert _traced_bytes(span, 10) == _traced_bytes(span, 10_000) == plain
    finally:
        tracemalloc.stop()
    assert plain[0] == 0


def test_spans_nest_as_the_layers(recorded):
    _, _, _, rows = recorded
    names = [r[0] for r in rows]
    assert names[0] == "study.plan" and rows[0][3] == -1
    assert rows[0][5] == {"lanes": len(POINTS) * len(SEEDS)}
    run = names.index("study.run")
    assert rows[run][3] == -1 and rows[run][5] == {"lanes": len(POINTS) * len(SEEDS)}
    for i, (name, s, e, parent, thread, _) in enumerate(rows):
        assert e is not None and s <= e and thread == rows[0][4]
        if parent >= 0:
            pname, ps, pe = rows[parent][:3]
            assert name in CHILDREN[pname], (name, pname)
            assert ps <= s and e <= pe
        else:
            assert name in ("study.plan", "study.run")
    kids = {rows[p][0] for _, _, _, p, _, _ in rows if p >= 0}
    assert kids == set(CHILDREN)
    assert {r[0] for r in rows if r[3] == run} == CHILDREN["study.run"]


def test_each_batched_tick_has_six_phases_and_one_gate_read(recorded):
    _, _, plan, rows = recorded
    lanes = plan.sim.stats["lanes"]
    loop = next(i for i, r in enumerate(rows) if r[0] == "lanes.loop")
    assert rows[loop][5] == {"batch_ticks": lanes["batch_ticks"],
                             "lane_ticks": sum(lanes["steps"])}
    seq = [r[0] for r in rows if r[3] == loop and r[0] != "lanes.leap"]
    tick = [*engine.TICK_SPANS.values(), "lanes.gate_read"]
    assert seq == ["lanes.gate_read"] + tick * lanes["batch_ticks"]
    counts = Counter(r[0] for r in rows)
    assert counts["lanes.leap"] == counts["lanes.leap_read"] >= 1


def test_recorded_study_bit_equal(recorded):
    off, on, _, _ = recorded
    _assert_results_equal(off, on)


def test_host_copy_counts_its_bytes(recorded):
    _, on, _, rows = recorded
    copy = [r for r in rows if r[0] == "study.host_copy"]
    assert len(copy) == 1
    assert copy[0][5] == {"bytes": sum(x.nbytes for x in state.tree_leaves(on.states))}


GRANTS = ("grants.demand", "grants.pick", "grants.credit")


def test_grants_spans_split_the_credit_path():
    """Under EQDS each ``tick.grants`` span holds one ``grants.demand``,
    ``grants.pick`` and ``grants.credit`` in that order, none with counts,
    and the recorded study is bit-equal to an unrecorded one."""
    off = _study(algo="eqds").run()
    with recording() as rec:
        plan = _study(algo="eqds")
        on = plan.run()
    _assert_results_equal(off, on)
    rows = rec.rows()
    grants = [i for i, r in enumerate(rows) if r[0] == "tick.grants"]
    assert len(grants) == plan.sim.stats["lanes"]["batch_ticks"]
    kids = {i: [] for i in grants}
    for i, (name, s, e, parent, _, counts) in enumerate(rows):
        if name in GRANTS:
            kids[parent].append(i)
            assert rows[parent][1] <= s <= e <= rows[parent][2]
    for i in grants:
        assert [rows[j][0] for j in kids[i]] == list(GRANTS)
        assert all(rows[j][5] == {} for j in kids[i])


def test_no_grants_spans_under_smartt(recorded):
    _, _, plan, rows = recorded
    assert not plan.sim.dims.credit_based
    assert not {r[0] for r in rows} & set(GRANTS)
    assert sum(r[0] == "tick.grants" for r in rows) == plan.sim.stats["lanes"]["batch_ticks"]


def test_mesh_shards_nest_within_their_threads():
    """Over ``mesh=["cpu"] * 2`` each shard's thread roots its spans in a
    ``lanes.shard`` span carrying the shard's index: its loop, ticks and
    reads nest within it, on its own thread."""
    off = _study().run()
    with recording() as rec:
        on = _study().run(mesh=[CPU] * 2)
    _assert_results_equal(off, on)
    rows = rec.rows()
    main = rows[0][4]
    roots = [i for i, r in enumerate(rows) if r[0] == "lanes.shard"]
    assert sorted(rows[i][5]["shard"] for i in roots) == [0, 1]
    threads = {rows[i][4] for i in roots}
    assert len(threads) == 2 and main not in threads and threading.get_ident() == main
    assert all(rows[i][3] == -1 for i in roots)    # a shard's thread starts its own stack
    for name, s, e, parent, thread, _ in rows:
        if thread != main and name != "lanes.shard":
            while rows[parent][3] >= 0:
                parent = rows[parent][3]
            assert parent in roots and rows[parent][4] == thread
            assert rows[parent][1] <= s and e <= rows[parent][2]
    loops = [r for r in rows if r[0] == "lanes.loop"]
    assert len(loops) == 2 and {r[4] for r in loops} == threads
    ticks = sum(r[5]["batch_ticks"] for r in loops)
    assert Counter(r[0] for r in rows)["tick.control"] == ticks


def test_anchor_puts_spans_on_the_profilers_clock():
    """A ``record_function`` range opened inside a span lies within the
    span, both on the clock of torch.profiler's kineto events."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof, recording() as rec:
        for i in range(3):
            with span("outer"):
                torch.ones(64).sum()        # a few µs on either side of the range
                with record_function(f"inner{i}"):
                    torch.ones(64).sum()
                torch.ones(64).sum()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    for i, (_, s, e, _, _, _) in enumerate(rec.rows()):
        ev = events[f"inner{i}"]
        assert s <= ev.start_ns() and ev.start_ns() + ev.duration_ns() <= e


def test_a_study_under_the_profiler_records_itself():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        plan = _study()
        plan.run()
    rec = last_profiled()
    assert rec is not None and plan.recording is rec
    names = [s.name for s in rec.spans]
    assert names[0] == "study.plan" and "study.run" in names and "lanes.loop" in names
    with recording() as outer:          # an open recording takes precedence
        with profiled() as inner:
            assert inner is None
        with span("x"):
            pass
    assert [s.name for s in outer.spans] == ["x"] and last_profiled() is rec


@pytest.mark.gpu
def test_span_holds_the_kernels_it_launched_on_the_card():
    """On the card, under a CUDA-only profiler session (the benchmark's): a
    span that issues one batched tick, four fused launches, and then
    synchronizes holds each launch's CUDA runtime record (the profiler's
    host clock, which the anchor is for) and, with the device's clock tied
    to the host's where the synchronize returns, each kernel's device
    interval; a study under the session records itself."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    fused = ("departures_kernel", "arrivals_kernel", "control_kernel", "sends_kernel")
    plan = api.study("tiny_3t", points=POINTS, seeds=SEEDS, device="cuda")
    plan.run()                          # the kernels' build and first launches
    sim = plan.sim
    st = sim.step(sim.init(), 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with recording() as rec:
            with span("probe"):
                st = sim.step(st, 1)
                torch.cuda.synchronize()
        again = api.study("tiny_3t", points=POINTS, seeds=SEEDS, device="cuda")
        again.run()
    (_, s, e, _, _, _), = (r for r in rec.rows() if r[0] == "probe")
    events = list(prof.profiler.kineto_results.events())
    host = {ev.correlation_id(): ev for ev in events if ev.device_type().name != "CUDA"}
    launched = [(ev, host[ev.correlation_id()]) for ev in events
                if ev.device_type().name == "CUDA" and ev.correlation_id() in host
                and s <= host[ev.correlation_id()].start_ns() <= e]
    names = sorted(k for ev, _ in launched for k in fused if k in ev.name())
    assert names == sorted(fused)
    for _, call in launched:
        assert s <= call.start_ns() and call.start_ns() + call.duration_ns() <= e
    sync = max((ev for ev in events if ev.name() == "cudaDeviceSynchronize"
                and s <= ev.start_ns() <= e), key=lambda ev: ev.start_ns())
    shift = sync.start_ns() + sync.duration_ns() - max(
        ev.start_ns() + ev.duration_ns() for ev, _ in launched)
    for ev, _ in launched:
        assert s <= ev.start_ns() + shift and ev.start_ns() + ev.duration_ns() + shift <= e
    assert again.recording is last_profiled() and again.recording is not None


@pytest.mark.gpu
def test_grants_marks_on_the_card():
    """On the card, a study under a CUDA-only profiler session (the
    benchmark's traced study) launches two ``span_mark_kernel`` a batched
    tick under EQDS, around the grants phase's operations, and none under
    SMaRTT; the marked study is bit-equal to an unmarked one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    for algo, per_tick in (("eqds", 2), ("smartt", 0)):
        off = api.study("tiny_3t", points=POINTS, seeds=SEEDS, device="cuda", algo=algo).run()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            plan = api.study("tiny_3t", points=POINTS, seeds=SEEDS, device="cuda", algo=algo)
            on = plan.run()
        _assert_results_equal(off, on)
        ops = sorted((e.start_ns(), e.name()) for e in prof.profiler.kineto_results.events()
                     if e.device_type().name == "CUDA")
        marks = [i for i, (_, n) in enumerate(ops) if "span_mark_kernel" in n]
        assert len(marks) == per_tick * plan.sim.stats["lanes"]["batch_ticks"]
        for a, b in zip(marks[::2], marks[1::2]):
            assert any("rr_pick_kernel" in n for _, n in ops[a + 1:b])
