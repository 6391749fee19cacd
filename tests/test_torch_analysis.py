"""PyTorch port, the static-analysis layer (``repro_torch.analysis``) on
the CPU: the counterparts of ``tests/test_analysis.py`` — every program
rule trips on a known-bad toy program and stays clean on a clean one,
every lint rule trips on a known-bad source snippet, the allowlist and
``# noqa`` work, ``trace_guard`` counts (nested windows too), the port's
own sources lint clean, and ``tiny_3t``/``tiny_perm4`` audit clean across
all nine programs.  Also the reference's one-build contracts
(``tests/test_api.py``): a 4-point x 4-seed study runs one lane loop and
its ``init()`` is one ``init_state`` call, equal to the lanes built one
at a time.  The catalogue audit and the cross-checks against the JAX
package are in ``test_torch_analysis_b.py``."""

import re
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import audit, lint, rules, trace_guard  # noqa: E402
from repro_torch.analysis.trace_guard import counter  # noqa: E402
from test_torch_engine import one_torch_thread  # noqa: E402,F401 (autouse)

CPU = "cpu"


def _rules_of(findings):
    return {f.rule for f in findings}


def _check(fn, site="toy", budgets=None):
    return audit.check_program(audit.record(fn), site, budgets=budgets)


# --------------------------------------------------------------------------
# program rules trip on deliberately bad programs
# --------------------------------------------------------------------------


def test_jx001_f64_leak_trips():
    x = torch.zeros(4, dtype=torch.float32)
    found = _check(lambda: x.to(torch.float64) * 2.0, "toy/f64")
    assert "JX001" in _rules_of(found)
    assert any(f.token.startswith("float64@aten._to_copy") for f in found)
    # the product of the wide value is derived, reported at its source only
    assert len([f for f in found if f.rule == "JX001"]) == 1


def test_jx001_clean_x32_program():
    x = torch.zeros(4, dtype=torch.float32)
    assert "JX001" not in _rules_of(_check(lambda: x * 2.0))


def test_jx001_python_scalar_where_is_a_wide_source():
    # torch.where of two Python ints makes an int64 tensor (the leak the
    # auditor found in sender.horizon); against an i32 tensor it does not
    c = torch.tensor([True, False])
    found = _check(lambda: torch.where(c, 0, 7))
    assert any(f.rule == "JX001" and f.token.startswith("int64@aten.scalar_tensor")
               for f in found)
    inf = torch.full((2,), 7, dtype=torch.int32)
    assert "JX001" not in _rules_of(_check(lambda: torch.where(c, 0, inf)))


def test_jx002_convert_chain_trips():
    # bool -> int32 -> float32: the middle cast is collapsible
    x = torch.zeros(4, dtype=torch.bool)
    found = _check(lambda: x.to(torch.int32).to(torch.float32), "toy/chain")
    assert "JX002" in _rules_of(found)
    assert any(f.token == "bool->int32->float32" for f in found)


def test_jx002_lossy_chain_not_flagged():
    # f32 -> i32 -> f32 truncates: semantics, not churn
    x = torch.zeros(4, dtype=torch.float32)
    assert "JX002" not in _rules_of(_check(lambda: x.to(torch.int32).to(torch.float32)))


def test_jx002_self_convert_trips_and_launch_operands_count_as_used():
    x = torch.zeros(4, dtype=torch.float32)
    found = _check(lambda: x.to(torch.float32, copy=True))
    assert any(f.rule == "JX002" and f.token == "float32->float32" for f in found)

    b = torch.zeros(4, dtype=torch.bool)

    def launched():
        y = b.to(torch.int32)
        y.data_ptr()                 # handed to a ctypes launch: a use
        return y.to(torch.float32)
    assert "JX002" not in _rules_of(_check(launched))


def test_jx003_host_sync_trips():
    x = torch.arange(6, dtype=torch.int32)
    mask = x > 2
    found = _check(lambda: int(x.sum()), "toy/sync")
    assert "JX003" in _rules_of(found)
    assert any(f.token.startswith("Tensor.__int__@") for f in found)
    # one sync, not two: the _local_scalar_dense under __int__ is recorded
    # as the same one
    prog = audit.record(lambda: int(x.sum()))
    assert "aten._local_scalar_dense.default" in prog.sequence
    assert audit.op_stats(prog).syncs == 1
    tokens = {f.token.split("@")[0] for f in _check(lambda: (x.tolist(), x[mask],
                                                             torch.nonzero(x)))}
    assert {"Tensor.tolist", "aten.index.Tensor[bool]", "aten.nonzero.default"} <= tokens


def test_jx003_clean_program():
    x = torch.arange(6, dtype=torch.int32)
    idx = torch.tensor([0, 2], dtype=torch.int64)
    assert "JX003" not in _rules_of(_check(lambda: torch.where(x > 2, x, 0)[idx]))


def test_jx004_aliased_state_trips():
    x = torch.zeros(8)
    found = audit.check_aliasing((x, x[2:6], torch.zeros(8)), "toy/alias")
    assert _rules_of(found) == {"JX004"}
    assert len(found) == 1           # one alias pair, third leaf is fresh
    # two views of one storage that do not overlap are two leaves
    assert audit.check_aliasing((x[:4], x[4:]), "toy") == []


def test_jx004_fresh_buffers_clean():
    assert audit.check_aliasing((torch.zeros(8), torch.zeros(8)), "toy") == []


def test_jx004_real_states_clean():
    from repro_torch.netsim import state
    from repro_torch.netsim.scenarios import scenario
    sim = scenario("tiny_3t").build(device=CPU)
    assert audit.check_aliasing(sim.init(), "tiny_3t/init") == []
    assert audit.check_aliasing(
        state.init_lanes(sim.dims, sim.consts, None, [0, 1, 2]), "tiny_3t/lanes") == []


def test_jx005_scatter_blowup_trips():
    idx = torch.tensor([1], dtype=torch.int32)

    def blowup():
        x = torch.zeros(16)
        for _ in range(6):
            x.index_put_((idx,), torch.ones(1))
        return x
    found = _check(blowup, "toy/scatter", budgets={"scatter": 3})
    assert "JX005" in _rules_of(found)
    # within budget: clean
    assert _check(blowup, "toy", budgets={"scatter": 6}) == []


def test_op_stats_counts_and_records_in_place_ops():
    idx = torch.tensor([0, 3], dtype=torch.int64)

    def fn(x):
        for i in range(4):
            x.index_add_(0, idx, torch.ones(2))
        return torch.gather(x, 0, idx)
    st = audit.op_stats(audit.record(lambda: fn(torch.zeros(8))))
    assert st.scatter == 4           # found inside the loop, in place
    assert st.gather == 1
    assert st.ops > 5
    assert st.est_bytes > 0


def test_launch_counts_cover_every_counting_wrapper():
    # every wrapper of a kernels/*/kernel.py that counts its launches
    # (`<wrapper>.launches += 1`, or `build.count(<wrapper>, launches=1)`,
    # the form safe under threads) is read
    src = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
    counted = {m for f in src.glob("*/kernel.py")
               for m in re.findall(r"^\s+(?:build\.count\()?(\w+)(?:\.launches \+= 1|, launches=1)",
                                   f.read_text(), re.M)}
    assert {f.__name__ for f in audit.launch_wrappers()} == counted
    assert {"departures", "arrivals", "control", "sends", "rr_pick"} <= counted
    from repro_torch.kernels.sends import kernel as sends

    def launch():
        sends.sends.launches += 1
    assert audit.record(launch).launches == {"sends": 1}


@pytest.mark.parametrize("counts,launches,want", [
    ((9, 9), 1, 9), ((137, 136), 0, None), ((0, 0), 1, None), ((0, 0), 0, 0)])
def test_profiler_kernels_needs_two_agreeing_sessions(counts, launches, want):
    assert audit.profiler_kernels(counts, launches) == want


# --------------------------------------------------------------------------
# JX006 — classification drift detector
# --------------------------------------------------------------------------


def test_jx006_catches_misclassified_static_key(monkeypatch):
    from repro_torch.netsim import api
    # pretend a Dims-changing knob were sweepable: JX006 must object
    monkeypatch.setattr(api, "CFG_KEYS", frozenset(api.CFG_KEYS | {"superstep"}))
    found = audit.classify_config()
    assert any(f.rule == "JX006" and f.token == "superstep" for f in found)


def test_jx006_clean_on_real_classification():
    assert [str(f) for f in audit.classify_config() if not f.allowlisted] == []


# --------------------------------------------------------------------------
# lint rules trip on deliberately bad sources
# --------------------------------------------------------------------------


def test_jx101_signature_drift_trips(tmp_path):
    kdir = tmp_path / "toy_kernel"
    kdir.mkdir()
    (kdir / "ref.py").write_text("def toy_ref(a, b, c):\n    return a + b + c\n")
    (kdir / "kernel.py").write_text("def toy(a, c, b):\n    return a + b + c\n")
    found = lint.check_kernel_parity(tmp_path)
    assert _rules_of(found) == {"JX101"}


def test_jx101_kwonly_statics_are_parity(tmp_path):
    kdir = tmp_path / "toy_kernel"
    kdir.mkdir()
    (kdir / "ref.py").write_text("def toy_ref(a, b, cap):\n    return a\n")
    (kdir / "kernel.py").write_text("def toy(a, b, *, cap, interpret=True):\n    return a\n")
    assert lint.check_kernel_parity(tmp_path) == []


def test_jx101_pairs_the_ports_lane_and_single_lane_entry_points(tmp_path):
    kdir = tmp_path / "fused"
    kdir.mkdir()
    (kdir / "ref.py").write_text(textwrap.dedent("""\
        def fused_ref(t, fl, o):
            pass
        def fused_lanes_ref(k, fl, o):
            pass
    """))
    (kdir / "kernel.py").write_text(textwrap.dedent("""\
        def fused(k, fl, o):
            pass
        def fused_at(t, o, fl):
            pass
    """))
    found = lint.check_kernel_parity(tmp_path)
    assert [f.token for f in found] == ["fused_ref|fused_at"]


def test_jx102_unregistered_scenario_trips(tmp_path):
    bench = tmp_path / "BENCH_netsim.json"
    bench.write_text(
        '{"schema": 1, "sections": {"perf": {"rows": '
        '[{"name": "no_such_scenario/jnp/k40", "ticks_per_sec": 1}]}}}')
    found = lint.check_ledger_keys(bench)
    assert _rules_of(found) == {"JX102"}
    assert found[0].token == "no_such_scenario"


def test_jx103_unseeded_random_trips(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent("""\
        import numpy as np
        import torch
        def jitter(n):
            return np.random.rand(n)
        def ok(n, seed):
            return np.random.default_rng(seed).random(n)
        def draw(n, g):
            a = torch.randn(n)
            b = torch.randn(n, generator=g)
            c = torch.empty(n).uniform_()
            d = torch.empty(n).normal_(generator=g)
            return a, b, c, d
    """))
    found = lint.check_random(bad)
    assert _rules_of(found) == {"JX103"}
    assert [(f.site.rsplit(":", 1)[1], f.token) for f in found] == [
        ("4", "np.random.rand"), ("8", "torch.randn"), ("10", "<tensor>.uniform_")]


def test_jx104_device_truthiness_trips(tmp_path):
    bad = tmp_path / "phase.py"
    bad.write_text(textwrap.dedent("""\
        import torch
        def control(dims, consts, st):
            if st.now > 5:
                return st
            if dims.trimming:      # static branch: fine
                pass
            while torch.any(st.done):
                break
            return st
    """))
    found = lint.check_truthiness(bad)
    assert [(f.rule, f.token) for f in found] == [("JX104", "st.now"),
                                                   ("JX104", "torch.any(...)")]


def test_jx105_device_math_on_host_path_trips(tmp_path):
    bad = tmp_path / "topo.py"
    bad.write_text(textwrap.dedent("""\
        import numpy as np
        import torch
        def build(n):
            return torch.arange(n)
        def device_fn(n):
            return torch.arange(n)
    """))
    found = lint.check_host_purity(bad)
    assert _rules_of(found) == {"JX105"}
    assert len(found) == 2
    # the device exemption works
    assert len(lint.check_host_purity(bad, device_functions=("device_fn",))) == 1


def test_noqa_suppresses_a_lint_finding(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import numpy as np\n"
                   "x = np.random.rand(3)  # noqa: JX103\n"
                   "y = np.random.rand(3)\n")
    found = lint.check_random(bad)
    assert len(found) == 1
    assert found[0].site.endswith(":3")


# --------------------------------------------------------------------------
# allowlist mechanics
# --------------------------------------------------------------------------


def test_allowlist_matches_and_justifies():
    f = rules.finding("JX001", "perm_1024n_3t/kernel/departures",
                      "int64@aten._to_copy.default@netsim/hashing.py:u32", "wide")
    assert f.allowlisted and rules.ALLOWLIST[f.allowed_by]
    # the same op elsewhere, or a float64 there, is not allowed
    f2 = rules.finding("JX001", "perm_1024n_3t/kernel/departures",
                       "int64@aten._to_copy.default@netsim/fabric.py:route", "wide")
    f3 = rules.finding("JX001", "perm_1024n_3t/kernel/departures",
                       "float64@aten._to_copy.default@netsim/hashing.py:u32", "wide")
    assert not f2.allowlisted and not f3.allowlisted


def test_every_allowlist_entry_has_a_justification():
    for key, why in rules.ALLOWLIST.items():
        rule, site, token = key.split(":", 2)
        assert rule in rules.RULES, key
        assert why.strip(), f"empty justification for {key}"
        assert token not in ("*", ""), f"blanket allowlist entry {key}"


# --------------------------------------------------------------------------
# trace_guard — the shared build-counting contract
# --------------------------------------------------------------------------


def test_trace_guard_counts_and_expects():
    c = counter("test.torch_analysis.guard")
    with trace_guard("test.torch_analysis.guard") as g:
        c.hit()
        c.hit()
    assert g.count == 2
    with pytest.raises(AssertionError, match="expected 1"):
        with trace_guard("test.torch_analysis.guard", expect=1):
            c.hit()
            c.hit()


def test_trace_guard_nested_windows_are_independent():
    c = counter("test.torch_analysis.nested")
    with trace_guard("test.torch_analysis.nested") as outer:
        c.hit()
        with trace_guard("test.torch_analysis.nested", expect=1) as inner:
            c.hit()
        assert inner.count == 1
    assert outer.count == 2


# --------------------------------------------------------------------------
# the one-build contracts (tests/test_api.py:63 and :127)
# --------------------------------------------------------------------------

POINTS = ({}, {"start_cwnd_mult": 0.5}, {"rto_mult": 5.0},
          {"start_cwnd_mult": 0.75, "num_entropies": 64})
SEEDS = (0, 3, 5, 7)


@pytest.fixture(scope="module")
def study():
    from repro_torch.netsim import api, workloads
    from repro_torch.netsim.scenarios import Scenario
    from repro_torch.netsim.state import SimConfig
    from repro_torch.netsim.units import FatTreeConfig, LinkConfig
    tree = FatTreeConfig(racks=2, nodes_per_rack=4, uplinks=2)
    wl = workloads.incast(tree, degree=4, size_bytes=32 * 4096, seed=1)
    sc = Scenario(name="t_incast4", cfg=SimConfig(link=LinkConfig(), tree=tree), wl=wl,
                  max_ticks=30_000)
    return api.study(sc, points=POINTS, seeds=SEEDS, device=CPU)


def test_study_runs_one_lane_loop(study):
    assert study.n_lanes == len(POINTS) * len(SEEDS)
    with trace_guard("shard.lane_loop", expect=1):
        res = study.run(max_ticks=100)
    assert len(res) == study.n_lanes


def test_study_single_init_state_call(study):
    """The [P*S] lane batch comes from ONE init_state call, equal leaf for
    leaf to the lanes built one at a time under their own constants."""
    from repro_torch.netsim import engine, state
    from repro_torch.netsim.api import apply_point
    with trace_guard("state.init", expect=1):
        states = study.init()
    np.testing.assert_array_equal(states.salt.numpy(), np.tile(SEEDS, len(POINTS)))
    for lane in range(study.n_lanes):
        pt, seed = study.lane_point_seed(lane)
        sim = engine.build(apply_point(study.scenario.cfg, dict(pt)), study.scenario.wl,
                           device=CPU)
        want = sim.init()._replace(salt=torch.tensor(seed, dtype=torch.int32))
        for a, b in zip(state.tree_leaves(want), state.tree_leaves(state.lane(states, lane))):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b)


# --------------------------------------------------------------------------
# the real repository is clean
# --------------------------------------------------------------------------


def test_lint_repo_self_clean():
    bad = [f for f in lint.lint_repo() if not f.allowlisted]
    assert bad == [], "\n".join(map(str, bad))


@pytest.mark.parametrize("name", ["tiny_3t", "tiny_perm4"])
def test_audit_small_scenarios_self_clean(name):
    from repro_torch.netsim.scenarios import scenario
    findings, rows = audit.audit_scenario(scenario(name), device=CPU)
    bad = [f for f in findings if not f.allowlisted]
    assert bad == [], "\n".join(map(str, bad))
    # the rows carry the budgeted op families of all nine programs, on both
    # backends, each the same program at two ticks, with no host sync and,
    # on the CPU, no launch
    assert {(r["backend"], r["program"]) for r in rows} == {
        (b, p) for b in audit.BACKENDS for p in audit.PROGRAMS}
    for r in rows:
        assert r["static"] and r["host_syncs"] == 0 and r["launches"] == 0, r
        assert {"aten_ops", "scatter_ops", "gather_ops", "convert_ops", "est_mb"} <= set(r)
