"""BENCHMARK.json and the files it names: every configuration, traffic
mix and metric found by name, within the limits the file keeps to, and
every metric's reader giving a number (or nothing, where its source is
absent) from a run's records."""

import math
import re

import pytest

from portbench_tiny import ROOT, load

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = load("BENCHMARK.json")
END = {m["name"] for m in BENCH["end_to_end"]}


def test_top_level_keys_and_command():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_found_by_name(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(conf["name"]) and conf["file"].startswith("portbench/configs/")
    body = load(conf["file"])
    assert body["name"] == conf["name"] and body["source"] == conf["source"]
    assert body["reduced"] == conf["reduced"]
    for key in conf["reduced"]:
        assert NAME.match(key) and key in body and key in body["source_values"]
    for key in ("fabric", "link", "transport", "max_ticks", "precision", "guarantees"):
        assert key in body
    assert len(conf["source"]) <= 200 and len(conf["why"]) <= 200


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_finds_its_configuration_and_mix(cell):
    from portbench.gen import traffic

    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    conf = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    mix = load(f"portbench/mixes/{cell['traffic']}.json")
    assert len(mix["points"]) * mix["seeds_per_study"] == int(cell["name"].rsplit("sweep", 1)[1])
    fabric = load(conf["file"])["fabric"]
    table = traffic.flows(fabric, mix["traffic"], 2**31 + 11)
    again = traffic.flows(fabric, mix["traffic"], 2**31 + 11)
    other = traffic.flows(fabric, mix["traffic"], 5)
    for key in ("src", "dst", "size", "t_start", "order"):
        assert (table[key] == again[key]).all()
    # another seed: the same sizes and start ticks, in another arrangement
    assert sorted(table["size"]) == sorted(other["size"])
    assert sorted(table["t_start"]) == sorted(other["t_start"])
    assert (table["src"] != table["dst"]).all()


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_found_by_name(metric):
    from portbench import harness

    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(harness.reader(metric["name"]))
    if metric["name"] in END:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in END and "bound" not in metric
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        for w in metric.get("workloads", []):
            assert w in {c["name"] for c in BENCH["workloads"]}


def fake_run(trace: bool):
    from portbench import harness

    study = dict(lanes=4, plan_s=0.1, run_s=0.5, wall_s=0.45, batch_ticks=100,
                 steps=[100, 90, 80, 100], ticks=[110, 90, 80, 100], leaps=[1, 0, 0, 0])
    run = harness.Run(config={}, mix={}, setup_s=3.0, window_s=1.2,
                      studies=[study, study], peak_bytes=2**30)
    if trace:
        ops = [("void control_kernel<true>(ControlArgs, int const*, bool const*)", 0, 4000),
               ("sends_kernel(SendsArgs, SendsTick, int const*, bool const*)", 5000, 3000),
               ("Memcpy DtoH (Device -> Pageable)", 9000, 1000)]
        rows = [dict(acks=50, timeouts=1, retx=2, packets=64)] * 4
        run.trace = dict(ops=ops, window_s=2e-5, busy_s=harness.busy_seconds(ops),
                         study=study, rows=rows, breakdown=harness.breakdown(ops))
        run.shapes = dict(N=8, NQ=24, NF=8, W=64, WW=2, FMAX=1, D=0, mtu=4096,
                          trimming=True, credit_based=False, rto_backoff_max=0)
    return run


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_reader_reads_a_run(metric):
    from portbench import harness

    read = harness.reader(metric["name"])
    v = read(fake_run(trace=True))
    assert isinstance(v, float) and math.isfinite(v)
    if metric["unit"] == "%":
        assert 0.0 <= v <= 100.0
    if metric["source"] == "device_trace":
        assert read(fake_run(trace=False)) is None


def test_breakdown_and_busy_time():
    from portbench import harness

    ops = [("a(x)", 0, 10), ("b(y)", 5, 10), ("a(x)", 30, 5)]
    assert harness.busy_seconds(ops) == pytest.approx(20e-9)
    b = harness.breakdown(ops)
    assert b["device_ops"] == [["a", 15e-9], ["b", 10e-9]]
    assert b["idle_gaps"] == [["b -> a", 15e-9]]


def test_files_stay_under_paths():
    assert (ROOT / "portbench" / "run.py").is_file()
    for conf in BENCH["configs"]:
        assert (ROOT / conf["file"]).resolve().is_relative_to(ROOT / "portbench")


def test_roofline_shapes_from_the_reference_match_the_program():
    pytest.importorskip("torch")
    from portbench import harness
    from portbench.gen import traffic
    from portbench_tiny import TINY_FABRIC, TINY_TRAFFIC
    from repro_torch.netsim import state as pstate

    conf = load("portbench/configs/smartt_1024n_3t.json")
    conf.update(fabric=TINY_FABRIC)
    mix = load("portbench/mixes/alltoall_sweep256.json")
    mix.update(traffic=TINY_TRAFFIC["alltoall"])
    table = traffic.flows(TINY_FABRIC, mix["traffic"], 17)
    shapes = harness.shapes_of(conf, table, mix)
    sc = harness.program_scenario("tiny", conf, table)
    _, _, d, _ = pstate.derive(sc.cfg, sc.wl, "cpu")
    assert shapes == {k: getattr(d, k) for k in shapes}
