"""PyTorch port, ``Sim.run_trace`` on the CPU against the JAX package's
``sim.run_trace`` (the per-tick outputs of Fig. 2's cwnd trace,
``benchmarks/fig_benchmarks.py``): ``q_max``, ``goodput``, ``done`` and
``delivered`` exactly, ``q_mean`` exactly (the reference's ``jnp.mean``
compiles to the exact integer sum times the f32 reciprocal of the queue
count, which the port computes the same way), and ``cwnd`` within Queue 3's
recorded budgets: its first difference from the reference within one
tick's 2 ULP, every tick within a run's 16.  The traced run takes every
tick — no exit gate, no leap — and its final state equals ``Sim.run``'s
with the leap off at the same tick."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.netsim import scenarios as jscen  # noqa: E402
from repro_torch.netsim import scenarios as tscen  # noqa: E402
from repro_torch.netsim import state as tstate  # noqa: E402
from test_torch_engine import RUN_ULP_BUDGET, _ulp  # noqa: E402
from test_torch_engine import one_torch_thread  # noqa: E402,F401 (autouse)

TICKS = 200
TICK_ULP_BUDGET = 2
KEYS = ("cwnd", "q_mean", "q_max", "delivered", "goodput", "done")


@pytest.mark.parametrize("name", ["tiny_incast3", "perm_128n_3t"])
def test_trace_matches_reference(name):
    jsim = jscen.scenario(name).build()
    _, jys = jsim.run_trace(TICKS, trace_flows=8)
    tsim = tscen.scenario(name).build(device="cpu")
    st, ys = tsim.run_trace(TICKS, trace_flows=8)
    assert set(ys) == set(jys) == set(KEYS)
    for k in KEYS:
        want, got = np.asarray(jys[k]), ys[k].numpy()
        assert want.dtype == got.dtype and want.shape == got.shape, k
        assert got.shape[0] == TICKS
        if k != "cwnd":
            np.testing.assert_array_equal(got, want, err_msg=k)
    want, got = np.asarray(jys["cwnd"]), ys["cwnd"].numpy()
    per_tick = [_ulp(want[t], got[t]) for t in range(TICKS)]
    assert max(per_tick) <= RUN_ULP_BUDGET
    first = next((u for u in per_tick if u), 0)
    assert first <= TICK_ULP_BUDGET
    assert int(st.now) == TICKS and tsim.stats["steps"] == TICKS
    print(f"{name}: cwnd differs from the reference on "
          f"{sum(u > 0 for u in per_tick)} of {TICKS} ticks, at most {max(per_tick)} ULP")


def test_trace_runs_every_tick_past_completion():
    """tiny_incast3 finishes at tick 23: the trace goes on to its end (the
    done count stays at the flow count), and its final state equals the
    gated run's with the leap off, driven tick by tick to the same tick."""
    sc = tscen.scenario("tiny_incast3")
    sim = sc.build(device="cpu")
    st, ys = sim.run_trace(60, trace_flows=2)
    assert ys["cwnd"].shape == (60, 2) and ys["goodput"].shape == (60, 2)
    nf = sim.dims.NF
    assert int(ys["done"][-1]) == nf and int(ys["done"][0]) == 0
    ref = tscen.scenario("tiny_incast3", leap=False).build(device="cpu")
    s = ref.init()
    for t in range(60):
        s = ref.step(s, t)
    for a, b in zip(tstate.tree_leaves(tstate.to_numpy(st)),
                    tstate.tree_leaves(tstate.to_numpy(s))):
        assert a.tobytes() == b.tobytes()


def test_q_mean_is_the_compiled_reference_mean_at_every_scenario_width():
    """``q_mean`` of the trace is the exact integer sum times the f32
    reciprocal of the queue count, which is what XLA makes of the
    reference's ``jnp.mean`` (a divide by a constant becomes a multiply by
    its reciprocal): equal bit for bit at the queue counts of six
    scenarios from 4 to 1024 nodes, on seeded queue sizes up to a port's
    capacity."""
    rng = np.random.default_rng(0)
    widths = sorted({tscen.scenario(n).build(device="cpu").dims.NQ
                     for n in ("tiny_incast3", "tiny_3t", "perm64", "perm_128n_3t",
                               "perm_512n_3t", "perm_1024n_3t")})
    for nq in widths:
        q = rng.integers(0, 41, size=(64, nq), dtype=np.int32)
        want = np.asarray(jax.jit(jax.vmap(lambda x: jnp.mean(x.astype(jnp.float32))))(q))
        sums = torch.from_numpy(q).sum(dim=1, dtype=torch.int32).to(torch.float32)
        got = (sums * torch.tensor(np.float32(1) / np.float32(nq))).numpy()
        assert want.tobytes() == got.tobytes(), nq
