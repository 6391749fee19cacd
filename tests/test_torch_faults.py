"""PyTorch port, fault schedules (paper Fig. 7's failed and degraded
fabric, the failover runs), against the JAX reference on the CPU:

* the per-tick evaluation — every port's service period, whether any
  fault is active, and the leap clamp to the next transition — at every
  transition of the four fault scenarios and the ticks on either side;
  the host mirrors the recovery metrics use (``np_port_period``,
  ``fault_ticks``, ``repair_times``, ``first_fault_time``);
* one tick from reference states on either side of corefail_128n_3t's
  failure (t = 500) and repair (t = 5990);
* leaping across transitions: a sparse scenario with a fail, a repair and
  a flap inside its idle stretches, leap on against leap off and against
  the reference;
* whole runs of flap_128n_3t and switchkill_128n_3t (blackholed packets,
  bytes delivered while faulted and the goodput history exactly); the
  corefail runs are in ``test_torch_pins_corefail.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.netsim import faults as jfaults  # noqa: E402
from repro.netsim import scenarios as jscen  # noqa: E402
from repro.netsim import state as jstate  # noqa: E402
from repro_torch.netsim import faults as tfaults  # noqa: E402
from repro_torch.netsim import scenarios as tscen  # noqa: E402
from repro_torch.netsim import state as tstate  # noqa: E402
from test_torch_engine import _assert_states_equal, assert_run_parity  # noqa: E402
from test_torch_engine import one_torch_thread  # noqa: E402,F401 (autouse)
from test_torch_tick import check_one_tick  # noqa: E402

FAULT_SCENARIOS = ("perm_512n_3t_degraded", "corefail_128n_3t", "flap_128n_3t",
                   "switchkill_128n_3t")


def _compiled(name):
    js, ts = jscen.scenario(name), tscen.scenario(name)
    jtopo, _, jdims, jconsts = jstate.derive(js.cfg, js.wl)
    ttopo, _, tdims, tconsts = tstate.derive(ts.cfg, ts.wl, device="cpu")
    jcf = jfaults.compile_tables(jfaults.lower(js.cfg.faults), jtopo, js.cfg.fault_start)
    tcf = tfaults.compile_tables(tfaults.lower(ts.cfg.faults), ttopo, ts.cfg.fault_start)
    return js, (jdims, jconsts, jcf), (tdims, tconsts, tcf)


@pytest.mark.parametrize("name", FAULT_SCENARIOS)
def test_port_period_and_transition_horizon_match_reference(name):
    js, (jd, jc, jcf), (td, tc, tcf) = _compiled(name)
    fs, T = js.cfg.fault_start, js.max_ticks
    edges = jfaults._breakpoints(jcf, fs, T)      # the degraded one: just 0
    assert jfaults.first_fault_time(jcf, fs, T) >= 0, name
    ticks = sorted({max(0, e + k) for e in edges for k in (-1, 0, 1)} | {T // 2, T - 1})
    for t in ticks:
        want = np.asarray(jfaults.port_period(jd, jc, jnp.int32(t)))
        got = tfaults.port_period(td, tc, t)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(want, got.numpy(), err_msg=f"{name} t={t}")
        np.testing.assert_array_equal(want, tfaults.np_port_period(tcf, fs, t))
        assert bool(jfaults.fault_active(jd, jc, jnp.int32(t))) == \
            bool(tfaults.fault_active(td, tc, t)), (name, t)
        assert int(jfaults.transition_horizon(jd, jc, jnp.int32(t))) == \
            int(tfaults.transition_horizon(td, tc, t)), (name, t)
    assert tfaults._breakpoints(tcf, fs, T) == edges
    assert tfaults.fault_ticks(tcf, fs, T) == jfaults.fault_ticks(jcf, fs, T)
    assert tfaults.repair_times(tcf, fs, T) == jfaults.repair_times(jcf, fs, T)
    assert tfaults.first_fault_time(tcf, fs, T) == jfaults.first_fault_time(jcf, fs, T)


def test_one_tick_across_failure_and_repair():
    """corefail_128n_3t: both core uplinks of T1 switch 0 die at t = 500
    and come back at t = 5990; the port's tick from the reference's state
    at 499-501 and 5989-5991 (and at the first tick of every event kind,
    blackholing among them) reproduces the reference's next state."""
    forced = (499, 500, 501, 5989, 5990, 5991)
    kinds, _, ticks = check_one_tick("corefail_128n_3t", forced)
    assert set(forced) <= set(ticks), ticks
    assert {"timeout", "retx", "trim", "deliver"} <= kinds, kinds


def _sparse_with_faults(mod):
    """tiny_sparse (two flows, then an idle stretch the run leaps over)
    with a fail, a repair, a degrade and a flap inside the idle time."""
    return mod.FaultSchedule(
        events=(mod.FaultEvent(t=300, kind="t0_up", i=0, j=0, period=0),
                mod.FaultEvent(t=900, kind="t0_up", i=0, j=0, period=1),
                mod.FaultEvent(t=950, kind="t0_up", i=1, j=1, period=2)),
        flaps=(mod.Flap(kind="t0_up", i=1, j=0, up=40, cycle=100, t=1000,
                        t_end=1400, period=0),))


def test_leap_never_crosses_a_transition():
    ticks = 1500
    sched_t = _sparse_with_faults(tfaults)
    on = tscen.scenario("tiny_sparse", faults=sched_t).build(device="cpu")
    off = tscen.scenario("tiny_sparse", faults=sched_t, leap=False).build(device="cpu")
    st_on = on.run(ticks)
    _assert_states_equal(st_on, off.run(ticks))
    assert on.stats["leaps"] > 0 and on.stats["steps"] < off.stats["steps"]
    # the clamp: from an idle tick before a transition the horizon stops on it
    st0 = on.init()
    for t, edge in ((250, 300), (899, 900), (1001, 1040)):
        assert int(tfaults.transition_horizon(on.dims, on.consts, t)) == edge - t
        assert int(on.horizon(st0, t)) <= edge - t
    # and the reference's run, leaping by its own horizon, ends in the same state
    js = jscen.scenario("tiny_sparse", faults=_sparse_with_faults(jfaults))
    jst = js.build().run(ticks)
    for (n, a), (_, b) in zip(_leaves(jst), _leaves(tstate.to_numpy(st_on))):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), n


def _leaves(tree, prefix=""):
    if hasattr(tree, "_fields"):
        for name, val in zip(tree._fields, tree):
            yield from _leaves(val, f"{prefix}.{name}" if prefix else name)
    else:
        yield prefix, tree


@pytest.mark.parametrize("name", ["flap_128n_3t", "switchkill_128n_3t"])
def test_whole_fault_run_matches_reference(name):
    ts = assert_run_parity(name)
    assert ts["blackholed"] > 0 and ts["delivered_bytes_fault"] > 0
    if name == "flap_128n_3t":
        from test_torch_pins_corefail import assert_pinned
        assert_pinned(name, ts)
