"""PyTorch port, whole runs on the CPU: the port's run loop against the
JAX reference's (per-flow FCT, ticks, trims, retransmissions and
delivered packets equal, and the whole final state: integer and boolean
leaves exactly, f32 leaves within ``RUN_ULP_BUDGET``), plus the port's own
contracts over the whole final state: leap-on equals leap-off, and K = 1
equals the default superstep.  Every whole run also holds the experiment
API's ``RunResult`` built from the two final states: ``row()`` and
``summary()`` equal the reference's.

Over a whole run the f32 CC state may drift further than in one tick:
XLA:CPU contracts the Wait-to-Decrease EWMA ``alpha*ecn + (1-alpha)*avg``
into a fused multiply-add and eager PyTorch does not, and an EWMA carries
each one-ULP rounding difference forward.  The integer trajectory (every
FCT, trim, retransmission, ACK) stays identical; the f32 leaves are held
to ``RUN_ULP_BUDGET``.  ``test_torch_tick.py`` holds one tick from a
reference state to 2 ULP."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.netsim import api as japi  # noqa: E402
from repro.netsim import metrics as jmetrics  # noqa: E402
from repro.netsim import scenarios as jscen  # noqa: E402
from repro_torch.netsim import api as tapi  # noqa: E402
from repro_torch.netsim import metrics as tmetrics  # noqa: E402
from repro_torch.netsim import scenarios as tscen  # noqa: E402
from repro_torch.netsim import state as tstate  # noqa: E402

RUN_ULP_BUDGET = 16    # a whole run: the EWMA carries rounding forward


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The simulator's CPU runs on one intra-op thread.  Its tensors are
    small and its operations many, so intra-op threads only add overhead,
    and with several test workers on one machine they contend badly (the
    port's CPU run files took 4x longer with them).  Test modules that run
    the simulator import this fixture, which makes it autouse there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=""):
    if hasattr(tree, "_fields"):
        for name, val in zip(tree._fields, tree):
            yield from _leaves(val, f"{prefix}.{name}" if prefix else name)
    else:
        yield prefix, tree


def _ulp(a, b):
    def key(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(key(a) - key(b)).max()) if np.size(a) else 0


def run_both(name, max_ticks=None, **overrides):
    """Reference and port runs of one scenario (port on the CPU), to
    completion or ``max_ticks`` (default: the scenario's budget)."""
    js = jscen.scenario(name, **overrides)
    mt = js.max_ticks if max_ticks is None else int(max_ticks)
    jsim = js.build()
    jst = jsim.run(mt)
    tsim = tscen.scenario(name, **overrides).build(device="cpu")
    tst = tsim.run(mt)
    return (jsim, jax.tree.map(np.asarray, jst), jmetrics.summarize(jsim, jst),
            tsim, tst, tmetrics.summarize(tsim, tst))


def assert_run_parity(name, require_done=True, max_ticks=None, **overrides):
    """Whole-run parity of one scenario, to completion or ``max_ticks``
    (``require_done=False`` for a run that ends at its tick budget with
    flows unfinished, as a failure without recovery does); the fault
    metrics (blackholed packets, bytes delivered while faulted, the
    goodput history) must be exact.  The experiment API's results built
    from the two final states must agree too: ``RunResult.row()`` on every
    key (no ``wall_s``: neither run is timed) and ``summary()``.  Returns
    the port's summary, with the port's row under ``"row"``."""
    jsim, jst, js, tsim, tst, ts = run_both(name, max_ticks, **overrides)
    assert (js["all_done"] and ts["all_done"]) or not require_done, name
    for key in ("ticks", "n_done", "fct_max", "fct_mean", "trims", "retx",
                "timeouts", "acks", "spurious_retx", "blackholed",
                "delivered_bytes_fault"):
        assert js[key] == ts[key], (name, key, js[key], ts[key])
    np.testing.assert_array_equal(js["fct_ticks"], ts["fct_ticks"])
    np.testing.assert_array_equal(js["goodput_hist"], ts["goodput_hist"])
    assert int(jst.m.delivered_pkts) == int(tst.m.delivered_pkts)
    worst = {}
    for (n, a), (_, b) in zip(_leaves(jst), _leaves(tstate.to_numpy(tst))):
        assert a.dtype == b.dtype and a.shape == b.shape, n
        if a.dtype == np.float32:
            worst[n] = _ulp(a, b)
            assert worst[n] <= RUN_ULP_BUDGET, (name, n, worst[n])
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{name} {n}")
    mt = jscen.scenario(name, **overrides).max_ticks if max_ticks is None else int(max_ticks)
    jres = japi.RunResult.from_state(jsim, jst, scenario=name, max_ticks=mt)
    tres = tapi.RunResult.from_state(tsim, tst, scenario=name, max_ticks=mt)
    assert "wall_s" not in tres.row()
    assert tres.row() == jres.row(), (name, tres.row(), jres.row())
    np.testing.assert_equal(tres.summary(), jres.summary())
    print(f"{name}: {ts['ticks']} ticks, {tsim.stats['steps']} executed; largest "
          f"f32 difference (ULP) {({k: v for k, v in worst.items() if v})}")
    ts["row"] = tres.row()
    return ts


@pytest.mark.parametrize("name", ["tiny_perm4", "tiny_3t", "tiny_sparse",
                                  "tiny_incast3", "perm_128n_3t"])
def test_whole_run_matches_reference(name):
    assert_run_parity(name)


@pytest.mark.parametrize("overrides", [
    dict(trimming=False),                       # losses recover by RTO
    dict(rto_backoff_max=3, trimming=False),    # capped exponential backoff
    dict(lb="spray"), dict(lb="ecmp"), dict(lb="plb"),
    dict(evict_on_timeout=True, trimming=False),
    dict(react_every=2),
], ids=lambda o: ",".join(f"{k}={v}" for k, v in o.items()))
def test_whole_run_options_match_reference(overrides):
    """The options SMaRTT supports (no trimming, RTO backoff, the other
    load balancers, eviction, reaction granularity) on a small incast."""
    ts = assert_run_parity("tiny_incast3", **overrides)
    if not overrides.get("trimming", True):
        assert ts["trims"] == 0


def _assert_states_equal(a, b):
    for (n, x), (_, y) in zip(_leaves(tstate.to_numpy(a)), _leaves(tstate.to_numpy(b))):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), n


# tiny_sparse is cut to its first 1500 ticks (two flows and an idle
# stretch between them): the leap-free run steps through every tick
@pytest.mark.parametrize("name,ticks", [("tiny_3t", None), ("perm_128n_3t", None),
                                        ("tiny_sparse", 1500)])
def test_leap_on_equals_leap_off(name, ticks):
    ticks = ticks or tscen.scenario(name).max_ticks
    on = tscen.scenario(name).build(device="cpu")
    off = tscen.scenario(name, leap=False).build(device="cpu")
    _assert_states_equal(on.run(ticks), off.run(ticks))
    assert off.stats["leaps"] == 0
    if name == "tiny_sparse":
        assert on.stats["leaps"] > 0 and on.stats["steps"] < off.stats["steps"]


@pytest.mark.parametrize("name", ["tiny_3t", "tiny_sparse", "perm_128n_3t"])
def test_superstep_k1_equals_default(name):
    sc = tscen.scenario(name)
    k1 = tscen.scenario(name, superstep=1).build(device="cpu")
    kd = sc.build(device="cpu")
    assert kd.dims.superstep > 1
    _assert_states_equal(k1.run(sc.max_ticks), kd.run(sc.max_ticks))


def test_max_ticks_budget_and_seed():
    """A budget below completion stops at exactly that tick; a nonzero
    seed changes the RED/ECMP salt, as in the reference."""
    sc = tscen.scenario("perm_128n_3t")
    sim = sc.build(device="cpu")
    st = sim.run(150)
    assert int(st.now) == 150 and not bool(st.done.all())
    j = jscen.scenario("perm_128n_3t").build()
    want = jmetrics.summarize(j, j.run(2000, seed=5))
    got = tmetrics.summarize(sim, sim.run(2000, seed=5))
    np.testing.assert_array_equal(want["fct_ticks"], got["fct_ticks"])
    assert want["trims"] == got["trims"]


def test_dependency_gated_run_matches_reference():
    """The activation gate with a dependency table (DESIGN.md Sec. 11): a
    hand-built chain on the 4-node tree, where flow 1 waits for 8 KiB of
    flow 0 and flow 2 for all of flow 1, runs as in the reference."""
    from repro.netsim import engine as jengine
    from repro.netsim import workloads as jwl
    from repro_torch.netsim import engine as tengine
    from repro_torch.netsim import workloads as twl
    cols = dict(src=np.array([0, 1, 2, 3], np.int32),
                dst=np.array([1, 2, 3, 0], np.int32),
                size=np.full(4, 32 * 1024, np.int32),
                t_start=np.zeros(4, np.int32), order=np.zeros(4, np.int32),
                dep_par=np.array([[-1], [0], [1], [-1]], np.int32),
                dep_thr=np.array([[0], [8 * 1024], [32 * 1024], [0]], np.int32))
    sc = tscen.scenario("tiny_perm4")
    jsim = jengine.build(jscen.scenario("tiny_perm4").cfg,
                         jwl.Workload(name="chain", **cols))
    tsim = tengine.build(sc.cfg, twl.Workload(name="chain", **cols), device="cpu")
    assert tsim.dims.D == 1
    want = jmetrics.summarize(jsim, jsim.run(20_000))
    got = tmetrics.summarize(tsim, tsim.run(20_000))
    assert want["all_done"] and got["all_done"]
    np.testing.assert_array_equal(want["fct_ticks"], got["fct_ticks"])
    assert want["ticks"] == got["ticks"]
