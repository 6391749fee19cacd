"""PyTorch port, the experiment API (``repro_torch.netsim.api``) on the
CPU: the counterparts of ``tests/test_api.py`` — every study lane equal to
the standalone ``Sim.run`` of its (point, seed) over the whole final state,
bitwise; ``Sim.run_batch`` and ``sweep.build_sweep`` equal to the study's
lanes; the plan-time rejections; name resolution; the derived fields;
point-major tidy rows; ``best`` ranking unfinished lanes strictly last.
The reference's one-compile assertions (``trace_guard``) are held in
``test_torch_analysis.py``: one lane loop a study, one ``init_state``
call a batch.  Also the ``trim_seen`` guard of
``RunResult.from_state`` on both sides of 2**24, and ``mesh=`` refused.
The study's rows against the JAX package's are in
``test_torch_api_rows.py`` (one file each keeps both under a minute)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.netsim import api as japi  # noqa: E402
from repro_torch.netsim import api, engine, scenarios, state, workloads  # noqa: E402
from repro_torch.netsim.api import apply_point  # noqa: E402
from repro_torch.netsim.scenarios import Scenario, scenario  # noqa: E402
from repro_torch.netsim.state import SimConfig  # noqa: E402
from repro_torch.netsim.sweep import build_sweep  # noqa: E402
from repro_torch.netsim.units import FatTreeConfig, LinkConfig  # noqa: E402
from test_torch_engine import one_torch_thread  # noqa: E402,F401 (autouse)

TREE = FatTreeConfig(racks=2, nodes_per_rack=4, uplinks=2)
POINTS = ({}, {"start_cwnd_mult": 0.5}, {"rto_mult": 5.0},
          {"start_cwnd_mult": 0.75, "react_every": 4})
SEEDS = (0, 3)
MAX_TICKS = 30_000
CPU = "cpu"


def _scenario(leap=True, **cfg_kw) -> Scenario:
    wl = workloads.incast(TREE, degree=4, size_bytes=32 * 4096, seed=1)
    return Scenario(name="t_incast4",
                    cfg=SimConfig(link=LinkConfig(), tree=TREE, leap=leap, **cfg_kw),
                    wl=wl, max_ticks=MAX_TICKS)


def _assert_state_equal(a, b):
    la, lb = state.tree_leaves(state.to_numpy(a)), state.tree_leaves(state.to_numpy(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


# --------------------------------------------------------------------------
# lanes equal standalone runs (leap on and off)
# --------------------------------------------------------------------------


def _standalone(sc):
    """{(point index, seed): final state} of standalone builds and runs."""
    out = {}
    for pi, pt in enumerate(POINTS):
        sim_i = engine.build(apply_point(sc.cfg, pt), sc.wl, device=CPU)
        assert sim_i.dims.leap == sc.cfg.leap
        for seed in SEEDS:
            out[pi, seed] = sim_i.run(MAX_TICKS, seed=seed)
    return out


@pytest.fixture(scope="module")
def incast_study():
    """The POINTS x SEEDS study of the small incast (leap on) and the
    standalone runs of its lanes, shared by the tests below."""
    sc = _scenario()
    return api.study(sc, points=POINTS, seeds=SEEDS, device=CPU).run(), _standalone(sc)


@pytest.mark.parametrize("leap", [True, False])
def test_study_lanes_match_standalone(leap, incast_study):
    """Every lane's final state equals the standalone ``Sim.run`` of its
    (point, seed) across the whole SimState — ``now``, metrics counters and
    RTT histograms included."""
    if leap:
        res, alone = incast_study
    else:
        sc = _scenario(leap=False)
        res, alone = api.study(sc, points=POINTS, seeds=SEEDS, device=CPU).run(), _standalone(sc)
    assert len(res) == len(POINTS) * len(SEEDS)
    for pi, pt in enumerate(POINTS):
        for si, seed in enumerate(SEEDS):
            st_i = alone[pi, seed]
            _assert_state_equal(st_i, state.lane(res.states, pi * len(SEEDS) + si))
            r = res.lane(pi, si)
            assert r.seed == seed and dict(r.point) == pt
            assert r.ticks == int(st_i.now)
            np.testing.assert_array_equal(r.fct, st_i.fct.numpy())
            _assert_state_equal(r.state, st_i)


def test_study_lanes_match_standalone_three_tier():
    sc = scenario("tiny_3t")
    points, seeds = ({}, {"start_cwnd_mult": 0.5}), (0, 3)
    res = api.study(sc, points=points, seeds=seeds, device=CPU).run()
    for pi, pt in enumerate(points):
        sim_i = engine.build(apply_point(sc.cfg, pt), sc.wl, device=CPU)
        assert sim_i.dims.tiers == 3
        for si, seed in enumerate(seeds):
            _assert_state_equal(sim_i.run(sc.max_ticks, seed=seed),
                                state.lane(res.states, pi * len(seeds) + si))


def test_points_with_equal_configs_share_one_build(monkeypatch):
    """A point that leaves the config as it is (the default start window)
    takes the base build's constants; distinct configs derive theirs once
    each.  The batched constants keep a leaf that no point changes shared
    (axis None) and give a swept one a row a lane, point-major."""
    derived = []
    real = api.state.derive
    monkeypatch.setattr(api.state, "derive",
                        lambda cfg, *a, **kw: derived.append(cfg) or real(cfg, *a, **kw))
    plan = api.study(_scenario(), points=[{"start_cwnd_mult": 1.25}, {},
                                          {"start_cwnd_mult": 0.5}], seeds=(0, 1),
                     device=CPU)
    assert [c.start_cwnd_mult for c in derived] == [0.5]    # beside the base build
    assert plan.axes.start_cwnd == 0 and plan.axes.kmin is None
    assert plan.consts_b.kmin is plan.sim.consts.kmin
    want = [plan.sim.consts.start_cwnd] * 4 + [0.5 / 1.25 * plan.sim.consts.start_cwnd] * 2
    assert plan.consts_b.start_cwnd.tolist() == [float(x) for x in want]


def test_build_sweep_lanes_match_study(incast_study):
    """``build_sweep`` is the single-seed study: its [P] states equal the
    seed-0 lanes of a study over the same points."""
    sc = _scenario()
    sweep = build_sweep(sc.cfg, sc.wl, list(POINTS), device=CPU)
    states_sweep = sweep.run(MAX_TICKS)
    res, _ = incast_study
    for pi in range(len(POINTS)):
        _assert_state_equal(state.lane(states_sweep, pi),
                            state.lane(res.states, pi * len(SEEDS)))
    rows = sweep.summaries(states_sweep)
    assert [r["fct_max"] for r in rows] == [res.lane(pi, 0).completion
                                            for pi in range(len(POINTS))]


def test_run_batch_matches_study_seed_lanes(incast_study):
    """``Sim.run_batch`` is the seeds-only study: the same stacked states,
    each lane the standalone ``run(seed=s)``."""
    sc = _scenario()
    sim = engine.build(sc.cfg, sc.wl, device=CPU)
    stb = sim.run_batch(np.asarray(SEEDS), max_ticks=MAX_TICKS)
    res, alone = incast_study
    np.testing.assert_array_equal(stb.salt, np.asarray(SEEDS, np.int32))
    for si, seed in enumerate(SEEDS):
        _assert_state_equal(alone[0, seed], state.lane(stb, si))
        _assert_state_equal(state.lane(res.states, si), state.lane(stb, si))


# --------------------------------------------------------------------------
# planner validation
# --------------------------------------------------------------------------


def test_study_rejects_dims_changing_and_unknown_keys():
    sc = _scenario()
    with pytest.raises(KeyError, match="changes Dims"):
        api.study(sc, points=[{"superstep": 4}], device=CPU)
    with pytest.raises(KeyError, match="changes Dims"):
        api.study(sc, points=[{"trimming": 0.0}], device=CPU)
    for key in ("departures_backend", "sender_backend"):     # the port's own
        with pytest.raises(KeyError, match="changes Dims"):
            api.study(sc, points=[{key: 0.0}], device=CPU)
    with pytest.raises(KeyError, match="unsweepable"):
        api.study(sc, points=[{"quantum_entanglement": 1.0}], device=CPU)
    with pytest.raises(ValueError, match="empty sweep"):
        api.study(sc, points=[], device=CPU)
    with pytest.raises(ValueError, match="empty seeds"):
        api.study(sc, seeds=[], device=CPU)
    with pytest.raises(ValueError, match="empty sweep"):
        build_sweep(sc.cfg, sc.wl, [], device=CPU)


def test_static_keys_name_every_other_config_field():
    """Every SimConfig field is sweepable or static, never both."""
    fields = {f.name for f in dataclasses.fields(SimConfig)}
    assert api.STATIC_KEYS | api.CFG_KEYS == fields
    assert not api.STATIC_KEYS & api.CFG_KEYS
    assert api.STATIC_KEYS - japi.STATIC_KEYS == {"departures_backend", "sender_backend"}
    assert api.CFG_KEYS == japi.CFG_KEYS and api.CC_PARAM_KEYS == japi.CC_PARAM_KEYS


def test_mesh_is_refused():
    """Lanes over several cards are not ported: ``mesh=`` raises and names
    the roadmap item, it never runs on one device instead."""
    plan = api.study(_scenario(), device=CPU)
    for call in (lambda: plan.run(mesh=object()), lambda: plan.run_states(mesh=object()),
                 lambda: plan.sim.run_batch([0], 10, mesh=object())):
        with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
            call()


def test_study_validates_workload_up_front():
    bad = workloads.Workload(
        name="bad", src=np.array([0, 1], np.int32), dst=np.array([0, 2], np.int32),
        size=np.array([4096, 4096], np.int32),
        t_start=np.zeros(2, np.int32), order=np.zeros(2, np.int32))
    sc = dataclasses.replace(_scenario(), wl=bad)
    with pytest.raises(ValueError, match="src == dst"):
        api.study(sc, device=CPU)
    with pytest.raises(ValueError, match="src == dst"):
        api.run(sc, device=CPU)


# --------------------------------------------------------------------------
# scenario names
# --------------------------------------------------------------------------


def test_scenario_registry_resolves_and_overrides():
    assert {"incast8_32n", "perm64", "sparse_heavy_32n",
            "tiny_incast3"} <= set(scenarios.names())
    sc = scenario("tiny_incast3", algo="swift", max_ticks=12_345)
    assert sc.cfg.algo == "swift" and sc.max_ticks == 12_345
    assert sc.name == "tiny_incast3"
    assert scenario("perm_64n").name == "perm64"
    with pytest.raises(KeyError, match="tiny_incast3"):
        scenario("no_such_scenario")


def test_api_accepts_scenario_names():
    r = api.run("tiny_incast3", device=CPU)
    assert r.scenario == "tiny_incast3" and r.all_done and r.wall_s > 0
    res = api.study("tiny_incast3", points=[{"start_cwnd_mult": a} for a in (0.5, 1.0)],
                    seeds=(0, 1), device=CPU).run()
    assert len(res) == 4 and all(rr.all_done for rr in res)


# --------------------------------------------------------------------------
# typed results
# --------------------------------------------------------------------------


def test_run_result_derived_fields():
    r = api.run("tiny_incast3", device=CPU)
    assert r.all_done and r.n_done == r.n_flows
    assert r.completion == int(r.fct_done.max())
    assert 0.0 < r.jain <= 1.0
    assert r.fct_min <= r.fct_mean <= r.fct_p99 <= r.completion
    assert np.nanmin(r.slowdown) > 0.9
    assert r.slowdown_p99 >= r.slowdown_mean > 0
    s = r.summary()
    assert s["fct_max"] == r.completion and s["trims"] == r.trims
    assert "wall_s" in r.row() and isinstance(r.state.fct, np.ndarray)


def test_study_result_rows_are_point_major_and_tidy():
    points = [{"start_cwnd_mult": a} for a in (0.5, 1.0, 1.25)]
    seeds = (0, 7)
    res = api.study("tiny_incast3", points=points, seeds=seeds, device=CPU).run()
    rows = res.rows()
    assert len(rows) == len(points) * len(seeds)
    for pi, pt in enumerate(points):
        for si, seed in enumerate(seeds):
            row = rows[pi * len(seeds) + si]
            assert row["point"] == pt and row["seed"] == seed
            assert row["scenario"] == "tiny_incast3"
            assert {"name", "completion", "jain", "slowdown_p99",
                    "trims", "ticks"} <= set(row)
    assert res.lane(2, 1).seed == 7
    assert dict(res.lane(2, 1).point) == points[2]
    assert res.by_point(1) == (res.lane(1, 0), res.lane(1, 1))
    assert res.best("completion").completion == min(r.completion for r in res)


def _synthetic_result(fct, done, seed):
    nf = len(fct)
    z = np.zeros(nf, np.int32)
    return api.RunResult(
        scenario="syn", algo="smartt", lb="reps", point=(), seed=seed,
        max_ticks=100, ticks=100, mtu=4096, brtt=10,
        fct=np.asarray(fct, np.int32), goodput=z, done=np.asarray(done, bool),
        size=np.full(nf, 4096, np.int32), t_start=z,
        flow_brtt=np.full(nf, 10.0, np.float32),
        trims=0, drops=0, blackholed=0, timeouts=0, retx=0, acks=0,
        spurious_retx=0, delivered_pkts=0, delivered_bytes=0.0,
        rtt_hist=np.zeros(8, np.int32), q_mean=0.0, q_max=0)


def _synthetic_study(results):
    return api.StudyResult(scenario="syn", points=((),) * len(results), seeds=(0,),
                           results=tuple(results), states=None, wall_s=0.0)


def test_best_unfinished_lanes_rank_strictly_last():
    unfinished_looks_great = _synthetic_result([0, -1], [True, False], seed=0)
    assert not unfinished_looks_great.all_done
    assert unfinished_looks_great.completion == 0
    finished_slow = _synthetic_result([50, 70], [True, True], seed=1)
    res = _synthetic_study([unfinished_looks_great, finished_slow])
    assert res.best("completion") is finished_slow
    assert res.best("fct_mean") is finished_slow
    assert res.best("slowdown_p99") is finished_slow
    part = _synthetic_result([5, -1], [True, False], seed=0)
    none_ = _synthetic_result([-1, -1], [False, False], seed=1)
    assert _synthetic_study([none_, part]).best("completion") is part
    twin_a = _synthetic_result([9, 9], [True, True], seed=0)
    twin_b = _synthetic_result([9, 9], [True, True], seed=1)
    assert _synthetic_study([twin_a, twin_b]).best("completion") is twin_a


# --------------------------------------------------------------------------
# the trim_seen guard (ROADMAP.md Queue 3)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("algo,guarded", [("eqds", True), ("eqds_smartt", True),
                                          ("smartt", False)])
def test_trim_seen_guard(algo, guarded):
    """A credit-based run whose largest ``trim_seen`` reaches 2**24 raises;
    one just below it, or a run without credits, builds its result."""
    sim = scenario("tiny_incast3", algo=algo).build(device=CPU)
    st = sim.run(200)
    for v, raises in ((2.0 ** 24 - 1, False), (2.0 ** 24, guarded)):
        st.trim_seen[1] = v
        if raises:
            with pytest.raises(ValueError, match="2\\*\\*24"):
                api.RunResult.from_state(sim, st, scenario="tiny_incast3", max_ticks=200)
        else:
            r = api.RunResult.from_state(sim, st, scenario="tiny_incast3", max_ticks=200)
            assert r.state.trim_seen[1] == v
