"""PyTorch port, the control phase: ``kernels/control``'s plain version
(``control_ref``, the fused kernel's contract and the CPU path) against the
JAX package's ``transport.control``, one phase at a time from
reference-dumped states.

The reference is driven tick by tick (``test_torch_tick._reference_pairs``:
the first tick of every event kind, evenly spread eventful ticks, and the
forced ones); at each chosen tick its departures and arrivals phases give
the state the control phase starts from, and its control phase the state
it must end in.  The port's control phase runs from the first: integer and
boolean leaves exact, f32 leaves within ``ULP_BUDGET`` (XLA:CPU contracts
the Wait-to-Decrease multiply-add, eager PyTorch does not: one ULP at
perm_128n_3t's tick 70).

Besides: the three ``transport_backend`` values give identical whole runs
on the CPU, and the event buffer holds what ``reps.on_ack`` and the
baselines' CC update read, with CCEvent's dtypes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch.core import registry, reps  # noqa: E402
from repro_torch.kernels.control import ref as XR  # noqa: E402
from repro_torch.netsim import scenarios as tscen  # noqa: E402
from repro_torch.netsim import state as tstate  # noqa: E402
from test_torch_engine import one_torch_thread  # noqa: E402,F401 (autouse)
from test_torch_tick import _leaves, _reference_pairs, _ulp  # noqa: E402

ULP_BUDGET = 2


def _phase(sim, name):
    return dict(sim.phases)[name]


def check_control_phase(name, forced=(), **overrides):
    """The port's control phase from the reference's pre-control state at
    each chosen tick; returns the kinds of control work seen."""
    jsim, pairs = _reference_pairs(name, forced, **overrides)
    jdep, jarr, jctl = (jax.jit(lambda st, f=_phase(jsim, n): f(jsim.consts, st))
                        for n in ("departures", "arrivals", "control"))
    tsim = tscen.scenario(name, **overrides).build(device="cpu")
    tctl = _phase(tsim, "control")
    kinds, worst = set(), {}
    for t, st_t, _, _, _ in pairs:
        pre = jarr(jdep(st_t))
        want = jax.tree.map(np.asarray, jctl(pre))
        pre = jax.tree.map(np.asarray, pre)
        R, NF = tsim.dims.R, tsim.dims.NF
        kinds |= {k for k, v in {
            "ack": want.m.n_ack > pre.m.n_ack,
            "timeout": want.m.n_to > pre.m.n_to,
            "spurious": want.m.spurious_retx > pre.m.spurious_retx,
            "trim": pre.trim_ring[t % R][:NF, 0].any(),
            "credit": pre.credit_ring[t % R][:NF].any(),
            "qa_fire": (pre.cc.trigger_qa & ~want.cc.trigger_qa).any(),
            "backoff": (want.rto_backoff > 0).any(),
        }.items() if v}
        clk = tsim.clock0._replace(t=t)
        got = tstate.to_numpy(tctl(tsim.consts, tstate.from_numpy(pre, "cpu"), clk))
        for (n, a), (_, b) in zip(_leaves(want), _leaves(got)):
            assert a.dtype == b.dtype and a.shape == b.shape, (name, t, n)
            if a.dtype == np.float32:
                worst[n] = max(worst.get(n, 0), _ulp(a, b))
                assert worst[n] <= ULP_BUDGET, (name, t, n, worst[n])
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{name} t={t} {n}")
    print(f"{name} {overrides}: control phase at ticks {[p[0] for p in pairs]}, "
          f"work {sorted(kinds)}, largest f32 difference (ULP) "
          f"{({k: v for k, v in worst.items() if v})}")
    return kinds, [p[0] for p in pairs]


@pytest.mark.parametrize("name,forced,overrides,needs", [
    ("perm_128n_3t", (70,), {}, {"ack", "trim", "qa_fire"}),
    ("alltoall_3t", (), {}, {"ack"}),
    ("tiny_incast3", (), dict(algo="eqds"), {"ack", "credit"}),
    ("incast8_16n", (), dict(rto_backoff_max=3, trimming=False),
     {"ack", "timeout", "backoff"}),
    ("incast8_16n", (), dict(evict_on_timeout=True, trimming=False),
     {"ack", "timeout"}),
], ids=["perm_128n_3t", "alltoall_3t", "eqds", "backoff", "evict"])
def test_control_phase_matches_reference(name, forced, overrides, needs):
    kinds, ticks = check_control_phase(name, forced, **overrides)
    assert needs <= kinds, (needs - kinds)
    assert set(forced) <= set(ticks)


def _assert_states_equal(a, b):
    for (n, x), (_, y) in zip(_leaves(tstate.to_numpy(a)), _leaves(tstate.to_numpy(b))):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), n


@pytest.mark.parametrize("name", ["tiny_3t", "perm_128n_3t"])
def test_transport_backends_give_identical_runs(name):
    """``"kernel"`` (control_ref on the CPU), ``"plain"`` and ``"split"``
    (the ring_drain and cc_update plain versions with the PyTorch glue)
    end in the same state, bit for bit."""
    sc = tscen.scenario(name)
    runs = {b: tscen.scenario(name, transport_backend=b).build(device="cpu")
            .run(sc.max_ticks) for b in ("kernel", "plain", "split")}
    assert bool(runs["kernel"].done.all())
    _assert_states_equal(runs["kernel"], runs["plain"])
    _assert_states_equal(runs["kernel"], runs["split"])


@pytest.mark.parametrize("algo", ["smartt", "swift", "eqds"])
def test_event_buffer_holds_what_its_readers_take(monkeypatch, algo):
    """Over the first ticks of tiny_incast3, the event the fused path hands
    to ``reps.on_ack`` and (for a baseline) to the CC update equals, field
    for field with CCEvent's dtypes, the event of the split path."""
    seen = {}

    def capture(backend):
        seen[backend] = {"cc": [], "lb": []}

        def cc_update(p, s, ev, now):
            # the fused phase runs on a lane batch ([1, NF] fields), the
            # split design on one lane ([NF])
            seen[backend]["cc"].append({k: v.clone().reshape(v.shape[-1:])
                                        for k, v in ev._asdict().items()})
            return orig_cc(p, s, ev, now)

        def on_ack(mode, p, s, has_ack, ecn, ent, flow_ids, now):
            seen[backend]["lb"].append(tuple(x.clone().reshape(x.shape[-1:])
                                             for x in (has_ack, ecn, ent)))
            return orig_on_ack(mode, p, s, has_ack, ecn, ent, flow_ids, now)
        monkeypatch.setitem(registry.ALGORITHMS, algo, cc_update)
        monkeypatch.setattr(reps, "on_ack", on_ack)

    orig_cc, orig_on_ack = registry.ALGORITHMS[algo], reps.on_ack
    for backend in ("kernel", "split"):
        capture(backend)
        sim = tscen.scenario("tiny_incast3", algo=algo, transport_backend=backend,
                             cc_backend="plain").build(device="cpu")
        sim.run(40)
    fused, split = seen["kernel"], seen["split"]
    assert len(fused["lb"]) == len(split["lb"]) == sim.stats["steps"] > 0
    for (a, b) in zip(fused["lb"], split["lb"]):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y)
    assert len(fused["cc"]) == len(split["cc"]) == sim.stats["steps"]
    assert any(bool(ev["has_ack"].any()) for ev in fused["cc"])
    for a, b in zip(fused["cc"], split["cc"]):
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert torch.equal(a[k], b[k]), k


def test_event_views_have_cc_event_dtypes():
    buf = XR.new_events(5, "cpu")
    ev = XR.events(buf)
    assert [(k, getattr(ev, k).dtype) for k, _ in XR.EVENT_FIELDS] == list(XR.EVENT_FIELDS)
    assert all(getattr(ev, k).shape == (5,) and getattr(ev, k).is_contiguous()
               for k in ev._fields)
    assert all(getattr(ev, k).untyped_storage().data_ptr() == buf.untyped_storage().data_ptr()
               for k in ev._fields)                      # views, no copies
    ev.has_ack.fill_(True)
    assert buf[0].view(torch.uint8)[:5].tolist() == [1] * 5
