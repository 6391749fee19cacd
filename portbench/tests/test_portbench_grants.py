"""The EQDS configuration, its mix and the grants phase's readers
(``metrics/tick.grants_us.py``, ``grants.ops_per_tick.py``,
``grants_roofline.py``; ``span_ops.py``, ``roofline/grants.py``): the
files load and the generator gives the cell's flows; on a synthetic
traced study each reader's number, the operations between the phase's
marks in stream order, and the byte count depending only on the shapes
and the lane-ticks; None without a trace, without the program's spans or
marks, or with marks that do not pair with the batched ticks; a tiny
EQDS cell run on the CPU is ``correct``, and not correct with a stated
guarantee of the configuration broken in the grants phase (the cell's
control: its float32 state holds whole MTUs, which bfloat16 holds too)."""

import json

import numpy as np
import pytest

from portbench_tiny import TINY_FABRIC, load

CELL = "incast1024.eqds.sweep512"
READERS = ("tick.grants_us", "grants.ops_per_tick", "grants_roofline")
CONFIG = "portbench/configs/eqds_1024n_3t.json"
MIX = "portbench/mixes/incast24_512k_eqds_sweep512.json"


def test_the_entries_of_the_benchmark():
    bench = load("BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == "eqds_1024n_3t")
    assert conf["file"] == CONFIG and conf["reduced"] == ["link"]
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert cell["config"] == "eqds_1024n_3t" and cell["chips"] == 1
    assert cell["traffic"] == "incast24_512k_eqds_sweep512"
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        assert per_layer[name]["workloads"] == [CELL]
        assert per_layer[name]["moves"] == "lanes_per_s"


def test_the_configuration_and_the_mix():
    conf, smartt, mix = load(CONFIG), load("portbench/configs/smartt_1024n_3t.json"), load(MIX)
    for key in ("fabric", "link", "reduced", "source_values"):
        assert conf[key] == smartt[key]
    assert conf["transport"] == {"algo": "eqds", "lb": "reps", "trimming": True,
                                 "num_entropies": 256, "credit_window_mult": 1.0}
    assert conf["max_ticks"] == 60000
    assert mix["traffic"] == {"kind": "incast", "degree": 24, "size_bytes": 524288}
    assert mix["seeds_per_study"] == 64
    assert sorted((p["credit_window_mult"], p["maxcwnd_mult"]) for p in mix["points"]) == \
        [(c, m) for c in (0.5, 1.0, 1.5, 2.0) for m in (1.0, 1.25)]


@pytest.mark.parametrize("seed", [0, 7, 2**33 + 5])
def test_the_generator_gives_24_flows_from_24_racks(seed):
    from portbench.gen import traffic

    conf, mix = load(CONFIG), load(MIX)
    t = traffic.flows(conf["fabric"], mix["traffic"], seed)
    m = conf["fabric"]["nodes_per_rack"]
    assert len(t["src"]) == 24 and np.all(t["size"] == 524288)
    assert len(np.unique(t["dst"])) == 1 and t["dst"][0] not in t["src"]
    racks = np.unique(t["src"] // m)
    assert len(racks) == 24 and racks.max() <= 24


def _run(with_spans: bool = True, lanes: int = 4, ticks: int = 3):
    """A traced study of the EQDS cell's configuration: ``ticks`` batched
    ticks of control, grants (its three spans) and sends, 10 µs each; on the card each tick's
    control kernel, then the grants phase's three operations of 100 ns
    between its two marks, then the sends kernel, the card behind the host
    so that the control kernel and the marks start after their spans."""
    from portbench import harness

    rows, ops, t = [], [], 0
    for _ in range(ticks):
        rows.append(("tick.control", t, t + 10_000, -1, 1, {}))
        ops.append(("control_kernel", t + 12_000, 8_000))
        g = len(rows)
        rows.append(("tick.grants", t + 10_000, t + 20_000, -1, 1, {}))
        rows += [("grants.demand", t + 10_000, t + 13_000, g, 1, {}),
                 ("grants.pick", t + 13_000, t + 16_000, g, 1, {}),
                 ("grants.credit", t + 16_000, t + 20_000, g, 1, {})]
        ops += [("span_mark_kernel()", t + 20_100, 50)]
        ops += [("elementwise", t + 20_200 + k * 200, 100) for k in range(3)]
        ops += [("span_mark_kernel()", t + 20_800, 50)]
        rows.append(("tick.sends", t + 20_000, t + 30_000, -1, 1, {}))
        ops.append(("sends_kernel", t + 21_000, 1_000))
        t += 30_000
    study = dict(lanes=lanes, plan_s=0.0, run_s=t / 1e9, wall_s=t / 1e9, batch_ticks=ticks,
                 steps=[ticks] * lanes, ticks=[ticks] * lanes, leaps=[0] * lanes)
    run = harness.Run(config=load(CONFIG), mix=load(MIX))
    run.trace = dict(ops=ops, window_s=t / 1e9, busy_s=harness.busy_seconds(ops), study=study,
                     rows=[], breakdown=harness.breakdown(ops))
    run.shapes = dict(N=1024, NQ=2304, NF=24, W=128, WW=4, FMAX=1, D=0, mtu=4096,
                      trimming=True, credit_based=True, rto_backoff_max=0)
    if with_spans:
        run.trace["spans"] = rows
    return run


def test_each_reader_on_spans():
    from portbench import harness, roofline, span_ops

    run = _run()
    got = {n: harness.reader(n)(run) for n in READERS}
    assert got["tick.grants_us"] == pytest.approx(10.0)
    assert got["grants.ops_per_tick"] == pytest.approx(3.0)
    pairs = span_ops.between_marks(run)
    assert [[o[0] for o in ops] for ops in pairs] == [["elementwise"] * 3] * 3
    # per live lane-tick 24 flows x 17 B, the tick and the window, one
    # cursor; per grant 12 B, 24 x (128 - 40) grants a lane
    nbytes = 12 * (24 * 17 + 8 + 4) + 4 * 24 * 88 * 12
    assert got["grants_roofline"] == pytest.approx(roofline.share(nbytes, 0.0, 9 * 100e-9))


def test_the_byte_count_depends_on_the_shapes_and_lane_ticks_alone():
    from portbench.roofline import grants

    run = _run()
    w = grants.workload(run)
    assert w == {"receivers": 1, "grants": 24 * 88}
    first = grants.study_bytes(run.shapes, 120, 4, w)
    run.trace["rows"] = [dict(acks=9, timeouts=1, retx=3, packets=3072)] * 4
    run.trace["ops"] = run.trace["ops"][:2]
    assert grants.study_bytes(run.shapes, 120, 4, grants.workload(run)) == first
    assert grants.study_bytes(run.shapes, 240, 4, w)[0] - first[0] == \
        120 * grants.lane_tick_bytes(run.shapes, 1)


def test_readers_give_nothing_without_a_trace():
    from portbench import harness

    run = _run()
    run.trace = None
    assert all(harness.reader(n)(run) is None for n in READERS)


def test_span_readers_give_nothing_without_the_recorder(monkeypatch):
    import importlib

    from portbench import harness

    guard = importlib.import_module("repro_torch.analysis.trace_guard")
    monkeypatch.delattr(guard, "last_profiled")
    run = _run(with_spans=False)
    got = {n: harness.reader(n)(run) for n in READERS}
    assert got["tick.grants_us"] is None
    assert got["grants.ops_per_tick"] == pytest.approx(3.0)


def test_a_program_without_the_grants_spans_and_marks():
    """The parent's program records ``tick.grants`` but neither the
    phase's inner spans nor the marks: only ``tick.grants_us`` reads."""
    from portbench import harness, span_ops

    run = _run()
    run.trace["spans"] = [r for r in run.trace["spans"] if not r[0].startswith("grants.")]
    run.trace["ops"] = [o for o in run.trace["ops"] if span_ops.MARK not in o[0]]
    got = {n: harness.reader(n)(run) for n in READERS}
    assert got["tick.grants_us"] == pytest.approx(10.0)
    assert all(got[n] is None for n in READERS[1:])


@pytest.mark.parametrize("lost", [0, 1])
def test_marks_that_do_not_pair_with_the_ticks_give_nothing(lost):
    """A lost mark (odd count) or a lost pair (fewer pairs than batched
    ticks) leaves the two device readers out."""
    from portbench import harness, span_ops

    run = _run()
    marks = [i for i, o in enumerate(run.trace["ops"]) if span_ops.MARK in o[0]]
    drop = set(marks[-1 - lost:])
    run.trace["ops"] = [o for i, o in enumerate(run.trace["ops"]) if i not in drop]
    assert harness.reader("grants.ops_per_tick")(run) is None
    assert harness.reader("grants_roofline")(run) is None


def _run_tiny_eqds(tmp_path, max_ticks=None):
    """The configuration on the 8-node tree, a 6:1 incast of 256 KiB (64
    packets, 24 on credit), two of the mix's points x 2 seeds, run and
    checked on the CPU."""
    from portbench import harness

    conf = load(CONFIG)
    conf.update(fabric=TINY_FABRIC, max_ticks=max_ticks or conf["max_ticks"])
    (tmp_path / "tiny.json").write_text(json.dumps(conf))
    mix = load(MIX)
    mix.update(traffic={"kind": "incast", "degree": 6, "size_bytes": 262144},
               points=[mix["points"][0], mix["points"][-1]], seeds_per_study=2)
    (tmp_path / "mixes").mkdir()
    (tmp_path / "mixes" / "tinymix.json").write_text(json.dumps(mix))
    bench = load("BENCHMARK.json")
    bench["configs"].append(dict(name="tiny", source="test", file=str(tmp_path / "tiny.json"),
                                 reduced=[], why="test"))
    bench["workloads"].append(dict(name="tiny.cell", config="tiny", traffic="tinymix",
                                   chips=1, why="test"))
    return harness.run_cell(bench, "tiny.cell", 2**33 + 9, 0.2, False, device="cpu",
                            mixes=tmp_path / "mixes", ref_workers=0)


def test_a_tiny_eqds_cell_is_correct(tmp_path):
    out = _run_tiny_eqds(tmp_path)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 4
    assert {k: v["value"] for k, v in out["checks"].items()} == \
        {"unfinished_lanes": 0, "lanes_off": 0, "fct_gap_ticks": 0}


def _crossed(grants):
    """Each lane's credit ring handed to the next lane after its grants:
    breaks each lane's bit-equality with its standalone run."""
    import torch

    def phase(dims, c, st, k, *, arb, ret):
        st = grants(dims, c, st, k, arb=arb, ret=ret)
        return st._replace(credit_ring=torch.roll(st.credit_ring, 1, 0))
    return phase


def _withheld(grants):
    """No credit granted: a flow's bytes after its speculative budget are
    never delivered."""
    return lambda dims, c, st, k, *, arb, ret: st


@pytest.mark.parametrize("fault, max_ticks, all_unfinished", [(_crossed, None, False),
                                                               (_withheld, 1500, True)])
def test_a_broken_guarantee_is_not_correct(tmp_path, monkeypatch, fault, max_ticks,
                                           all_unfinished):
    """The configuration's stated guarantees broken in the grants phase:
    the run comes out not correct."""
    pytest.importorskip("torch")
    from repro_torch.netsim import sender

    monkeypatch.setattr(sender, "grants", fault(sender.grants))
    out = _run_tiny_eqds(tmp_path, max_ticks)
    assert out["correct"] is False
    unfinished = out["checks"]["unfinished_lanes"]["value"]
    assert unfinished == (out["attempted"] if all_unfinished else 0) and out["attempted"] > 0
    assert out["checks"]["lanes_off"]["value"] > 0


@pytest.mark.parametrize("seed", [3, 2**32 + 5])
def test_the_bfloat16_control_moves_only_a_leaf_eqds_never_reads(seed):
    """The precision control comes out not equal only through
    ``cc.last_dec`` (Swift's and MPRDMA's, -1e9 from the start, which
    bfloat16 cannot hold): EQDS's credits, budget and window are whole
    MTUs, so every row key and completion tick agree.  Hence the cell's
    control is a broken guarantee, above."""
    from portbench.gen import traffic
    from portbench.reference import check

    conf = load(CONFIG)
    conf.update(fabric=TINY_FABRIC)
    table = traffic.flows(TINY_FABRIC, {"kind": "incast", "degree": 6, "size_bytes": 262144}, seed)
    point = load(MIX)["points"][seed % 8]
    salt = traffic.salts(seed, 0, 1)[0]
    ref = check.reference_lane((conf, table, "tiny", point, salt, None))
    ctl = check.reference_lane((conf, table, "tiny", point, salt, "bfloat16"))
    assert check.leaves_off(ctl[0], ref[0]) == ["cc.last_dec"]
    assert check.row_off(ctl[1], ref[1]) == []
    assert check.lane_gap(ctl[0], ctl[1], ref[0], ref[1]) == (1, 0)
