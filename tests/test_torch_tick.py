"""PyTorch port, one tick at a time: the reference drives
``jax.jit(sim.step)`` from ``init()`` and keeps ``(state_t, state_t+1)``
at chosen ticks (ticks with trims, retransmissions, QuickAdapt firing,
timeouts, deliveries); the port loads ``state_t`` with ``from_numpy``,
takes one step, and must reproduce ``state_t+1``: integer and boolean
leaves exactly, f32 leaves within ``ULP_BUDGET``.  Because every check
starts from a reference state, drift cannot compound.  The port's
next-event horizon must also equal the reference's at every chosen tick
(the leap lands on the same tick)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.netsim import engine as jengine  # noqa: E402
from repro.netsim import metrics as jmetrics  # noqa: E402
from repro.netsim import scenarios as jscen  # noqa: E402
from repro_torch.netsim import scenarios as tscen  # noqa: E402
from repro_torch.netsim import state as tstate  # noqa: E402
from test_torch_engine import one_torch_thread  # noqa: E402,F401 (autouse)

ULP_BUDGET = 2
MAX_PAIRS = 24
# Ticks always checked: perm_128n_3t's tick 70 is the first whose f32 CC
# state differs between the reference (XLA:CPU fuses the Wait-to-Decrease
# EWMA alpha*ecn + (1-alpha)*avg into one multiply-add) and the port
# (eager, unfused): cc.avg_wtd of flow 8 by one ULP.
FORCED = {"perm_128n_3t": (70,)}


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


def _features(st, st1):
    """Which events the tick st -> st1 contains."""
    m, m1 = st.m, st1.m
    return {
        "trim": int(m1.n_trim) > int(m.n_trim),
        "retx": int(m1.n_retx) > int(m.n_retx),
        "timeout": int(m1.n_to) > int(m.n_to),
        "ack": int(m1.n_ack) > int(m.n_ack),
        "deliver": int(m1.delivered_pkts) > int(m.delivered_pkts),
        "qa_fire": bool(jnp.any(st.cc.trigger_qa & ~st1.cc.trigger_qa)),
    }


def _reference_pairs(name, forced=(), **overrides):
    """Run the reference tick by tick (leaping idle stretches as its run
    loop does) and keep up to MAX_PAIRS eventful (t, state_t, state_t+1,
    horizon_t) as numpy — the first tick of every event kind, then evenly
    spread eventful ticks, and every tick in ``forced``."""
    sc = jscen.scenario(name, **overrides)
    sim = jengine.build(sc.cfg, sc.wl)
    step, horizon = jax.jit(sim.step), jax.jit(sim.horizon)
    st = sim.init()
    seen, eventful = set(), []
    t = 0
    while t < sc.max_ticks and not bool(jnp.all(st.done)):
        h = int(horizon(st))
        if sim.dims.leap and h > 0 and t not in forced:
            # a leap stops at the next forced tick, which is then stepped
            # (stepping an idle tick equals leaping over it)
            d = min([h, sc.max_ticks - t] + [f - t for f in forced if f > t])
            occ = jnp.sum(st.q_size[:-1])
            st = st._replace(now=st.now + d,
                             m=jmetrics.leap_account(st.m, jnp.int32(d), occ))
            t += d
            continue
        st1 = step(st)
        feats = _features(st, st1)
        if t in forced:
            eventful.append((True, t, st, st1, h, feats))
        elif any(feats.values()):
            new = {k for k, v in feats.items() if v} - seen
            seen |= new
            eventful.append((bool(new), t, st, st1, h, feats))
        st, t = st1, t + 1
    firsts = [e for e in eventful if e[0]]
    rest = [e for e in eventful if not e[0]]
    k = max(MAX_PAIRS - len(firsts), 0)
    picked = firsts + rest[::max(1, len(rest) // max(k, 1))][:k]
    to_np = lambda s: jax.tree.map(np.asarray, s)
    return sim, [(t, to_np(a), to_np(b), h, f) for _, t, a, b, h, f in
                 sorted(picked, key=lambda e: e[1])]


def check_one_tick(name, forced=(), **overrides):
    """The port's tick (and horizon) from each of the reference's chosen
    states; returns the event kinds seen and the largest f32 difference
    at the forced ticks."""
    jsim, pairs = _reference_pairs(name, forced, **overrides)
    assert pairs, name
    tsim = tscen.scenario(name, **overrides).build(device="cpu")
    if name == "tiny_sparse":
        assert tsim.dims.FMAX > 1          # the rr_pick arbitration runs
    kinds = set()
    worst, at_forced = {}, 0
    for t, st_t, st_t1, h_ref, feats in pairs:
        kinds |= {k for k, v in feats.items() if v}
        port = tstate.from_numpy(st_t, "cpu")
        assert int(tsim.horizon(port, t)) == h_ref, (name, t)
        out = tstate.to_numpy(tsim.step(port, t))
        want, got = list(_leaves(st_t1)), list(_leaves(out))
        assert [n for n, _ in want] == [n for n, _ in got]
        for (n, a), (_, b) in zip(want, got):
            assert a.dtype == b.dtype and a.shape == b.shape, (name, t, n)
            if a.dtype == np.float32:
                u = _ulp(a, b)
                worst[n] = max(worst.get(n, 0), u)
                assert u <= ULP_BUDGET, (name, t, n, u)
                if t in forced:
                    at_forced = max(at_forced, u)
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{name} t={t} {n}")
    print(f"{name} {overrides}: {len(pairs)} ticks {[p[0] for p in pairs]}, events "
          f"{sorted(kinds)}, largest f32 difference (ULP) "
          f"{({k: v for k, v in worst.items() if v})}")
    return kinds, at_forced, [p[0] for p in pairs]


@pytest.mark.parametrize("name", ["tiny_incast3", "tiny_perm4", "tiny_3t",
                                  "tiny_sparse", "perm_128n_3t"])
def test_one_tick_from_reference_state(name):
    kinds, at_forced, _ = check_one_tick(name, FORCED.get(name, ()))
    if name == "perm_128n_3t":
        assert {"trim", "retx", "qa_fire", "ack", "deliver"} <= kinds
        # one ULP where XLA:CPU fuses the multiply-add (a CPU with FMA),
        # none where it cannot
        assert at_forced <= 1
