"""The span readers (``metrics/api.host_copy_ms.py``, ``tick.host_us.py``,
``lanes.{gate_wait,leap,self}_us.py``) and ``spans.py``'s two breakdown
rows, on synthetic runs and on a study the program recorded under a CPU
profiler session: each reader's number, None where the program has no
recorder (the parent), the idle time charged to the innermost span open
over it, and the rows summing to the window's idle time."""

import pytest

from portbench_tiny import load

SPAN_READERS = ("api.host_copy_ms", "tick.host_us", "lanes.gate_wait_us", "lanes.leap_us",
                "lanes.self_us")
TICK = ("tick.departures", "tick.arrivals", "tick.control", "tick.grants", "tick.sends",
        "tick.metrics")


def test_the_readers_are_entries_of_the_benchmark():
    per_layer = {m["name"]: m for m in load("BENCHMARK.json")["per_layer"]}
    for name in SPAN_READERS:
        m = per_layer[name]
        assert m["source"] == "program_span" and m["better"] == "lower"
        assert m["moves"] == "lanes_per_s" and "workloads" not in m
    assert per_layer["tick.host_us"]["layer"] == "tick phases"


def synthetic_run(with_spans: bool = True):
    """A traced study of 2 batched ticks in a 100 µs window (ns): planning,
    then the run: init, the loop (a gate read, a leap holding its read, two
    ticks of six phases and a gate read each), the host copy, the rows."""
    from portbench import harness

    rows = [("study.plan", 0, 10_000, -1, 1, {"lanes": 4}),
            ("study.run", 10_000, 95_000, -1, 1, {"lanes": 4}),
            ("study.init", 11_000, 12_000, 1, 1, {}),
            ("lanes.loop", 12_000, 80_000, 1, 1, {"batch_ticks": 2, "lane_ticks": 8}),
            ("lanes.gate_read", 13_000, 14_000, 3, 1, {}),
            ("lanes.leap", 14_000, 18_000, 3, 1, {}),
            ("lanes.leap_read", 15_000, 17_000, 5, 1, {})]
    t = 20_000
    for _ in range(2):
        for name in TICK:
            rows.append((name, t, t + 2_000, 3, 1, {}))
            t += 2_000
        rows.append(("lanes.gate_read", t, t + 10_000, 3, 1, {}))
        t += 12_000
    rows += [("study.host_copy", 81_000, 90_000, 1, 1, {"bytes": 1 << 20}),
             ("study.results", 90_000, 94_000, 1, 1, {})]
    # the card: busy through each gate read but its first 2 µs, and the copy
    ops = [("k(a)", s + 2_000, e - s - 2_000) for n, s, e, *_ in rows
           if n == "lanes.gate_read" and e - s > 2_000]
    ops.append(("Memcpy DtoH (Device -> Pageable)", 81_000, 9_000))
    study = dict(lanes=4, plan_s=1e-5, run_s=8.5e-5, wall_s=8e-5, batch_ticks=2,
                 steps=[2] * 4, ticks=[2] * 4, leaps=[0] * 4)
    run = harness.Run(config={}, mix={})
    run.trace = dict(ops=ops, window_s=1e-4, busy_s=harness.busy_seconds(ops), study=study,
                     rows=[], breakdown=harness.breakdown(ops))
    if with_spans:
        run.trace["spans"] = rows
    return run


def test_each_reader_on_spans():
    from portbench import harness

    run = synthetic_run()
    got = {n: harness.reader(n)(run) for n in SPAN_READERS}
    assert got["api.host_copy_ms"] == pytest.approx(9e-3)
    assert got["tick.host_us"] == pytest.approx(12.0)          # 2 ticks x 6 x 2 µs / 2
    assert got["lanes.gate_wait_us"] == pytest.approx(10.5)    # (1 + 10 + 10) µs / 2
    assert got["lanes.leap_us"] == pytest.approx(2.0)
    # the loop's 68 µs less its children's 24 + 21 + 4
    assert got["lanes.self_us"] == pytest.approx(9.5)
    per_tick = sum(got[n] for n in SPAN_READERS[1:])
    assert per_tick == pytest.approx((80_000 - 12_000) / 2 / 1e3)


def test_readers_give_nothing_without_the_recorder(monkeypatch):
    """The parent's program has no recorder: every span reader gives None
    and the breakdown keeps its two keys."""
    import importlib

    from portbench import harness

    guard = importlib.import_module("repro_torch.analysis.trace_guard")
    monkeypatch.delattr(guard, "last_profiled")
    run = synthetic_run(with_spans=False)
    for n in SPAN_READERS:
        assert harness.reader(n)(run) is None
    assert set(run.trace["breakdown"]) == {"device_ops", "idle_gaps"}
    run.trace = None
    assert all(harness.reader(n)(run) is None for n in SPAN_READERS)


def test_idle_by_span_charges_the_innermost_span():
    from portbench import spans

    rows = [("outer", 0, 100, -1, 1, {}), ("inner", 20, 40, 0, 1, {}),
            ("inner", 60, 70, 0, 1, {}), ("deep", 62, 66, 2, 1, {})]
    ops = [("k", 0, 10), ("k", 30, 40), ("k", 90, 30)]   # busy 0-10, 30-70, 90-120
    out = spans.idle_by_span(ops, rows, 150e-9)          # window 0-150
    got = {k: round(v * 1e9) for k, v in out}
    assert got == {"outer": 10 + 20, "inner": 10, spans.OUTSIDE: 30}
    assert out[-1][0] == spans.OUTSIDE
    assert sum(v for _, v in out) == pytest.approx(150e-9 - 10e-9 - 40e-9 - 30e-9)


def test_idle_by_span_keeps_ten_names_and_sums_to_the_idle_time():
    from portbench import spans

    rows = [(f"s{i}", 10 * i, 10 * i + 5, -1, 1, {}) for i in range(14)]
    out = spans.idle_by_span([("k", 5, 3)], rows, 140e-9)
    assert [k for k, _ in out][-2:] == [spans.OTHERS, spans.OUTSIDE] and len(out) == 12
    assert sum(v for _, v in out) == pytest.approx(137e-9)
    assert dict(out)[spans.OUTSIDE] == pytest.approx(2e-9 + 13 * 5e-9)


def test_device_clock_follows_the_sync_points():
    """The device's clock 5 µs behind the host's and falling further behind
    by one part in 20; each read returns 2 µs after its copy ends and each
    departures kernel starts 1 µs into its span.  Between the first and the
    last sync point every span lands where its host time less 2 µs lies on
    the device's clock, so each kernel starts inside its span."""
    from portbench import spans

    def dev(t):
        return t - (5_000 + t // 20)

    rows = [("lanes.gate_read", 0, 10_000, -1, 1, {})]
    for k in range(5):
        t = 20_000 * (k + 1)
        rows += [("tick.departures", t, t + 6_000, -1, 1, {}),
                 ("lanes.gate_read", t + 8_000, t + 10_000, -1, 1, {})]
    ops = []
    for n, s, e, *_ in rows:
        if n == "lanes.gate_read":
            ops.append(("Memcpy DtoH (Device -> Pageable)", dev(e - 2_000) - 500, 500))
        else:
            ops.append(("departures_kernel(DeparturesArgs)", dev(s + 1_000), 900))
    got = spans.device_clock(rows, ops)
    assert [r[0] for r in got] == [r[0] for r in rows]
    for (_, s, e, *_), (_, s2, e2, *_) in zip(rows, got):
        for t, t2 in ((s, s2), (e, e2)):
            if 10_000 <= t <= 90_000:
                assert abs(t2 - dev(t - 2_000)) <= 1
    kernels = sorted(o[1] for o in ops if o[0].startswith("departures"))
    dep = [g for g in got if g[0] == "tick.departures"]
    assert all(g[1] < k < g[2] for g, k in zip(dep, kernels))
    assert spans.device_clock(rows, ops[:1] + ops[2:]) is rows   # a launch unmatched


def test_breakdown_rows_added_once(monkeypatch):
    """Spans the trace holds already are read as they are; spans read from
    the program add the two rows to the breakdown once."""
    from portbench import harness, spans

    run = synthetic_run()
    assert harness.reader("tick.host_us")(run) is not None
    assert set(run.trace["breakdown"]) == {"device_ops", "idle_gaps"}
    rows = run.trace.pop("spans")
    monkeypatch.setattr(spans, "_program_spans", lambda run: rows)
    assert harness.reader("tick.host_us")(run) == pytest.approx(12.0)
    b = run.trace["breakdown"]
    assert set(b) == {"device_ops", "idle_gaps", "host_spans", "idle_by_span"}
    assert spans.of(run) is rows and run.trace["breakdown"] is b
    idle = run.trace["window_s"] - run.trace["busy_s"]
    assert sum(v for _, v in b["idle_by_span"]) == pytest.approx(idle, rel=1e-9)
    assert b["host_spans"][0] == ["lanes.gate_read", pytest.approx(21e-6)]
    assert len(b["host_spans"]) == 10


def test_a_study_recorded_under_the_profiler(tiny):
    """A tiny study planned and run under a CPU profiler session, as the
    traced study is on the card: its spans are the program's last profiled
    recording, and the four per-tick readers sum to the loop's time."""
    torch = pytest.importorskip("torch")
    from torch.profiler import ProfilerActivity, profile

    from portbench import harness, spans
    from portbench.gen import traffic

    from repro_torch.netsim import api

    bench, name, mixes = tiny("permutation")
    cell, conf = harness.cell_of(bench, name)
    config = harness.load_json(harness.ROOT / conf["file"])
    mix = harness.load_json(mixes / f"{cell['traffic']}.json")
    table = traffic.flows(config["fabric"], mix["traffic"], 2**33 + 5)
    sc = harness.program_scenario(name, config, table)
    torch.set_num_threads(1)
    salts = traffic.salts(2**33 + 5, 0, int(mix["seeds_per_study"]))
    with profile(activities=[ProfilerActivity.CPU]):
        plan, res, plan_s, run_s = harness.one_study(api, sc, harness.points_of(mix), salts,
                                                     "cpu", torch)
    run = harness.Run(config=config, mix=mix)
    run.trace = dict(ops=[], window_s=plan_s + run_s, busy_s=0.0,
                     study=harness.study_record(plan, res, plan_s, run_s), rows=[],
                     breakdown=harness.breakdown([]))
    got = {n: harness.reader(n)(run) for n in SPAN_READERS}
    assert all(v is not None and v > 0 for k, v in got.items() if k != "lanes.leap_us")
    rows = run.trace["spans"]
    loop = [r for r in rows if r[0] == "lanes.loop"]
    loop_us = sum(e - s for _, s, e, *_ in loop) / run.trace["study"]["batch_ticks"] / 1e3
    assert sum(got[n] for n in SPAN_READERS[1:]) == pytest.approx(loop_us, rel=1e-9)
    idle = dict(run.trace["breakdown"]["idle_by_span"])
    assert sum(idle.values()) == pytest.approx(run.trace["window_s"], rel=0.01)
    assert idle[spans.OUTSIDE] < 0.1 * run.trace["window_s"]
