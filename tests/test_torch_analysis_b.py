"""PyTorch port, the static-analysis layer held against the JAX package's
(``repro.analysis``) on the CPU: JX006's per-field Dims impact equal for
every field the two ``SimConfig``s share, JX102's findings over
``BENCH_netsim.json`` equal, JX103 and JX104 giving the same rule ids and
lines on the same toy sources, ``trace_guard`` giving the same counts for
the same hit sequence.  And the counterpart of ``tests/test_analysis.py``'s
catalogue audit (the reference's ``slow`` mark): every registered
scenario on both backends with zero unallowlisted findings.  The toy
programs and rules are in ``test_torch_analysis.py``."""

import dataclasses
import importlib
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import audit as japi_audit  # noqa: E402
from repro.analysis import lint as jlint  # noqa: E402
from repro_torch.analysis import audit, lint  # noqa: E402
from repro_torch.netsim import scenarios  # noqa: E402
from test_torch_engine import one_torch_thread  # noqa: E402,F401 (autouse)


# --------------------------------------------------------------------------
# JX006: the Dims impact of every shared SimConfig field
# --------------------------------------------------------------------------


def _reference_dims_impact(name="tiny_3t") -> dict:
    """The JAX package's Dims impact of each SimConfig field perturbed alone
    (``audit._perturb`` through ``state.derive``): None for a structural
    field, "raised" where derive refuses the perturbation."""
    from repro.netsim import state as jstate
    from repro.netsim.scenarios import scenario
    sc = scenario(name)
    _, _, dims0, _ = jstate.derive(sc.cfg, sc.wl)
    out = {}
    for field in dataclasses.fields(jstate.SimConfig):
        new = japi_audit._perturb(getattr(sc.cfg, field.name))
        if new is None:
            out[field.name] = None
            continue
        try:
            _, _, dims2, _ = jstate.derive(
                dataclasses.replace(sc.cfg, **{field.name: new}), sc.wl)
        except Exception:
            out[field.name] = "raised"
            continue
        out[field.name] = dims2 != dims0
    return out


def test_jx006_dims_impact_equals_the_reference():
    want = _reference_dims_impact()
    table = audit.config_table()
    got = {k: (None if v is None else "raised" if isinstance(v, str) else v["dims"])
           for k, v in table.items()}
    shared = set(want) & set(got)
    assert shared >= {"superstep", "leap", "trimming", "rto_mult", "num_entropies",
                      "start_cwnd_mult", "fault_start", "rto_backoff_max"}
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
    # the port's two extra fields are backend selectors, structural
    assert set(got) - set(want) == {"departures_backend", "sender_backend"}
    assert got["departures_backend"] is None and got["sender_backend"] is None
    # a sweepable field keeps the Consts leaves' shapes and dtypes too
    from repro_torch.netsim import api
    for k in api.CFG_KEYS:
        assert table[k] == {"dims": False, "consts": False}, k


# --------------------------------------------------------------------------
# JX102: the ledger's scenario keys
# --------------------------------------------------------------------------


def test_jx102_findings_equal_the_reference():
    def key(fs):
        return sorted((f.rule, f.site, f.token, f.allowed_by) for f in fs)
    got, want = lint.check_ledger_keys(), jlint.check_ledger_keys()
    assert key(got) == key(want)
    assert [f.token for f in got] == ["perm_32n_flat"] and got[0].allowlisted


def test_jx102_toy_ledger_equals_the_reference(tmp_path):
    bench = tmp_path / "BENCH_netsim.json"
    bench.write_text(
        '{"schema": 1, "sections": {'
        '"perf": {"rows": [{"name": "no_such/jnp/k40"}, {"name": "perm64/jnp"}]}, '
        '"failover": {"rows": [{"name": "corefail_128n_3t+recovery/smartt"}, '
        '{"scenario": "gone_3t"}]}, "roofline": {"rows": [{"name": "x/y"}]}}}')

    def key(fs):
        return [(f.rule, f.site, f.token) for f in fs]
    assert key(lint.check_ledger_keys(bench)) == key(jlint.check_ledger_keys(bench)) == [
        ("JX102", "BENCH_netsim.json:perf", "no_such"),
        ("JX102", "BENCH_netsim.json:failover", "gone_3t")]


# --------------------------------------------------------------------------
# JX103 / JX104: the same toy sources, the same rule ids and lines
# --------------------------------------------------------------------------

RANDOM_TOY = """\
import numpy as np
import numpy
def jitter(n, seed):
    a = np.random.rand(n)
    b = np.random.default_rng(seed).random(n)
    np.random.seed(seed)
    c = numpy.random.normal(size=n)  # noqa: JX103
    d = np.random.Generator(np.random.PCG64(seed))
    e = np.random.permutation(n)  # noqa
    f = np.random.randint(0, n)  # noqa: JX104
    return a, b, c, d, e, f
"""

TRUTH_TOY = """\
def control(dims, consts, st, state):
    if st.now > 5:
        return st
    if dims.trimming:      # static branch: fine
        pass
    while state.cc.cwnd.sum() < 0:
        break
    assert consts.rto is not None
    x = 1 if st.done else 0
    ok = bool(consts.kmin)
    if st.now:  # noqa: JX104
        pass
    y = [v for v in range(3) if v]
    return x, ok, y
"""


def _lines(findings):
    return [(f.rule, int(f.site.rsplit(":", 1)[1])) for f in findings]


def test_jx103_same_findings_as_the_reference(tmp_path):
    src = tmp_path / "rand.py"
    src.write_text(RANDOM_TOY)
    got, want = lint.check_random(src), jlint.check_random(src)
    assert _lines(got) == _lines(want) == [("JX103", 4), ("JX103", 6), ("JX103", 10)]
    assert [f.token for f in got] == [f.token for f in want]


def test_jx104_same_findings_as_the_reference(tmp_path):
    src = tmp_path / "phase.py"
    src.write_text(TRUTH_TOY)
    got, want = lint.check_truthiness(src), jlint.check_truthiness(src)
    assert _lines(got) == _lines(want) == [
        ("JX104", 2), ("JX104", 6), ("JX104", 8), ("JX104", 9), ("JX104", 10)]
    assert sorted(f.token for f in got) == sorted(f.token for f in want)


def test_jx104_message_names_a_host_sync(tmp_path):
    # the port's JX104 names a host sync, the reference's a trace error
    src = tmp_path / "phase.py"
    src.write_text(textwrap.dedent("""\
        def sends(dims, consts, st):
            if st.now:
                pass
    """))
    (got,), (want,) = lint.check_truthiness(src), jlint.check_truthiness(src)
    assert (got.rule, got.site, got.token) == (want.rule, want.site, want.token)
    assert "host sync" in got.message


# --------------------------------------------------------------------------
# trace_guard: the same counts for the same hit sequence
# --------------------------------------------------------------------------


def _guard_run(mod, name):
    """Counts, and the nested windows' failures, of one hit sequence."""
    c = mod.counter(name)
    seen = []
    with mod.trace_guard(name) as outer:
        c.hit()
        with mod.trace_guard(name) as inner:
            c.hit()
            c.hit()
        seen.append(inner.count)
        try:
            with mod.trace_guard(name, expect=2):
                c.hit()
        except AssertionError as e:
            seen.append(str(e))
        with mod.trace_guard(name, expect=0) as idle:
            pass
        seen.append(idle.count)
    seen.append(outer.count)
    try:
        with mod.trace_guard(name, expect=5):
            raise KeyError("inside")      # the block's own error propagates
    except KeyError:
        seen.append("propagated")
    return seen


def test_trace_guard_counts_equal_the_reference():
    got = _guard_run(importlib.import_module("repro_torch.analysis.trace_guard"),
                     "test.torch_analysis_b.guard")
    want = _guard_run(importlib.import_module("repro.analysis.trace_guard"),
                      "test.torch_analysis_b.guard")
    assert got == want
    assert got[0] == 2 and got[2] == 0 and got[3] == 4 and got[4] == "propagated"
    assert "expected 2 trace(s) inside the block, saw 1" in got[1]


# --------------------------------------------------------------------------
# the whole catalogue is clean
# --------------------------------------------------------------------------


def _canonical_names() -> list:
    seen = []
    for name in scenarios.names():
        canon = scenarios.scenario(name).name   # aliases resolve to one name
        if canon not in seen:
            seen.append(canon)
    return seen


@pytest.mark.slow
@pytest.mark.parametrize("name", _canonical_names())
def test_audit_full_catalogue_self_clean(name):
    """The reference's catalogue audit, one case a registered scenario (its
    aliases deduped): both backends, zero unallowlisted findings."""
    sc = scenarios.scenario(name)
    findings, rows = audit.audit_scenario(
        sc, device="cpu", per_phase=name in audit.PER_PHASE_SCENARIOS)
    bad = [f for f in findings if not f.allowlisted]
    assert bad == [], "\n".join(map(str, bad))
    names = {r["name"] for r in rows}
    assert f"{name}/plain/step" in names and f"{name}/kernel/step" in names
    if name == "perm_512n_3t":
        # the paper-scale scenario records per-phase budget rows
        assert "perm_512n_3t/plain/arrivals" in names
    assert all(r["host_syncs"] == 0 and r["static"] for r in rows)
    # JX004 ran on its states: the allowlisted JX001s are the only findings
    assert {f.rule for f in findings} <= {"JX001"}


def test_audit_catalogue_adds_the_config_classification():
    findings, rows = audit.audit_catalogue(names=["tiny_incast3", "tiny_incast3"],
                                           backends=("plain",), device="cpu")
    assert [r["name"] for r in rows] == ["tiny_incast3/plain/step"]
    assert [f for f in findings if not f.allowlisted] == []
