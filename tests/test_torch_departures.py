"""PyTorch port, the departures phase: ``kernels/departures``' plain
versions against the JAX package's ``fabric.departures``, one phase at a
time from reference-dumped states.

The reference is driven tick by tick (``test_torch_tick._reference_pairs``);
at each chosen tick its start-of-tick state is the state the departures
phase starts from, and its departures phase gives the state it must end in.
The port's departures phase (``departures_ref`` on the CPU, the fused
kernel's contract) runs from the first: every leaf exact (the phase does no
f32 arithmetic on the state; the mark's f32 quotient only decides a bit).
The fault scenarios force ticks across corefail_128n_3t's failure (t = 500)
and repair (t = 5990), into flap_128n_3t's first down window (t = 500) and
before its flap starts (t = 200), and perm_512n_3t_degraded serves a
half-rate port on even ticks only.

Besides: ``departures_by_port`` (the kernel's formulation) equals
``departures_ref`` on every seeded ``departures_case``; the two
``departures_backend`` values give identical whole runs; an unknown backend
raises; and the operands the kernel's block holds are the same tensors every
tick of a run, none that the phase writes sharing storage with another.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch.kernels import cases  # noqa: E402
from repro_torch.kernels.departures import kernel as DK  # noqa: E402
from repro_torch.kernels.departures import ref as DR  # noqa: E402
from repro_torch.netsim import faults as tfaults  # noqa: E402
from repro_torch.netsim import scenarios as tscen  # noqa: E402
from repro_torch.netsim import state as tstate  # noqa: E402
from test_torch_control import _assert_states_equal  # noqa: E402
from test_torch_engine import one_torch_thread  # noqa: E402,F401 (autouse)
from test_torch_faults import _sparse_with_faults  # noqa: E402
from test_torch_tick import _leaves, _reference_pairs  # noqa: E402


def _phase(sim, name):
    return dict(sim.phases)[name]


def _kinds(pre, want, nq, qe, core, edge):
    """The kinds of departures work the reference's tick did."""
    rows = np.concatenate([want.infl[core, :qe], want.infl[edge, qe:nq]])
    emitted = rows[:, 0] == 1
    hol = pre.q_fields[np.arange(nq), pre.q_head[:nq]]
    return {k for k, v in {
        "emit": emitted.any(),
        "mark": (emitted & (rows[:, 5] == 1) & (hol[:, 3] == 0)).any(),
        "deliver": (emitted & (rows[:, 1] < 0)).any(),
        "wrap": ((pre.q_size[:nq] > 0) & (want.q_head[:nq] < pre.q_head[:nq])).any(),
        "black": want.m.n_black > pre.m.n_black,
        "held": ((pre.q_size[:nq] > 0) & (want.q_size[:nq] == pre.q_size[:nq])).any(),
    }.items() if v}


def check_departures_phase(name, forced=(), **overrides):
    """The port's departures phase from the reference's start-of-tick state
    at each chosen tick; returns the kinds of work seen and the ticks."""
    jsim, pairs = _reference_pairs(name, forced, **overrides)
    jdep = jax.jit(lambda st: _phase(jsim, "departures")(jsim.consts, st))
    tsim = tscen.scenario(name, **overrides).build(device="cpu")
    tdep = _phase(tsim, "departures")
    d, L = tsim.dims, tsim.dims.L
    kinds = set()
    for t, st_t, _, _, _ in pairs:
        want = jax.tree.map(np.asarray, jdep(st_t))
        clk = tsim.clock0._replace(t=t)
        kinds |= _kinds(st_t, want, d.NQ, d.QE, (t + clk.lat_core) % L,
                        (t + clk.lat_edge) % L)
        got = tstate.to_numpy(tdep(tsim.consts, tstate.from_numpy(st_t, "cpu"), clk))
        for (n, a), (_, b) in zip(_leaves(want), _leaves(got)):
            assert a.dtype == b.dtype and a.shape == b.shape, (name, t, n)
            assert a.tobytes() == b.tobytes(), f"{name} t={t} {n}"
    ticks = [p[0] for p in pairs]
    print(f"{name} {overrides}: departures phase at ticks {ticks}, work {sorted(kinds)}")
    return kinds, ticks


@pytest.mark.parametrize("name,forced,overrides,needs", [
    ("perm_128n_3t", (), {}, {"emit", "mark", "deliver", "wrap"}),
    ("corefail_128n_3t", (499, 500, 501, 5989, 5990, 5991), {},
     {"emit", "mark", "deliver", "black"}),
    ("flap_128n_3t", (150, 199, 200, 499, 500, 501, 650), dict(max_ticks=660),
     {"emit", "deliver", "black"}),
    ("perm_512n_3t_degraded", (), dict(max_ticks=200), {"emit", "mark", "black", "held"}),
], ids=["perm_128n_3t", "corefail", "flap", "degraded"])
def test_departures_phase_matches_reference(name, forced, overrides, needs):
    kinds, ticks = check_departures_phase(name, forced, **overrides)
    assert needs <= kinds, (needs - kinds)
    assert set(forced) <= set(ticks)


@pytest.mark.parametrize("shape,seed,flags", cases.DEPARTURES_CASES)
def test_departures_by_port_equals_ref(shape, seed, flags):
    """The kernel's formulation (a port at a time in Python integers)
    computes the contract's function on seeded operands: every operand bit
    for bit, and the cases take the branches they are for."""
    c = cases.departures_case(*shape, seed, **flags)
    t, lat, fl, ref = cases.departures_operands(c, "cpu")
    _, _, _, own = cases.departures_operands(c, "cpu")
    _, _, _, before = cases.departures_operands(c, "cpu")
    DR.departures_ref(t, lat, fl, ref)
    DR.departures_by_port(t, lat, fl, own)
    for n, a, b in zip(ref._fields, ref, own):
        assert a.dtype == b.dtype and a.numpy().tobytes() == b.numpy().tobytes(), n
    nq, qe, L = shape[0], shape[1], ref.infl.shape[0]
    core, edge = (t + lat.core) % L, (t + lat.edge) % L
    rows = torch.cat([ref.infl[core, :qe], ref.infl[edge, qe:nq]])
    emitted = rows[:, 0] == 1
    assert emitted.any() and not rows[~emitted].any()          # idle rows zeroed
    assert (rows[emitted, 1] < 0).any() and (rows[emitted, 1] >= 0).any()
    moved = before.q_size[:nq] - ref.q_size[:nq]
    assert bool(((moved == 0) | (moved == 1)).all()) and int(moved.sum()) > 0
    assert bool((ref.q_head[:nq] != before.q_head[:nq]).eq(moved == 1).all())
    # nothing but the ports' rows of the two slots changed on the wire
    changed = (ref.infl != before.infl).any(dim=2)
    changed[core, :qe] = changed[edge, qe:nq] = False
    assert not changed.any()
    faulty = bool(fl.fk or fl.flapped)
    assert faulty == bool(ref.n_black > before.n_black)
    if faulty:                                  # served ports skipped, not drained
        assert bool(((before.q_size[:nq] > 0) & (moved == 0)).any())
    if shape[0] > 100:
        hol = before.q_fields[torch.arange(nq), before.q_head[:nq]]
        assert bool((emitted & (rows[:, 5] == 1) & (hol[:, 3] == 0)).any())   # marks
        assert bool(((hol[:, 0] < 0) | (hol[:, 0] >= shape[2]))[moved == 1].any())


@pytest.mark.parametrize("name,overrides", [
    ("tiny_3t", {}),
    ("tiny_sparse", dict(faults=_sparse_with_faults(tfaults))),
], ids=["tiny_3t", "faults"])
def test_departures_backends_give_identical_runs(name, overrides):
    """``"kernel"`` (``departures_ref`` on the CPU) and ``"plain"`` end in
    the same state, bit for bit: tiny_3t run to its end, tiny_sparse with a
    fail, a repair, a degrade and a flap for 1500 ticks (blackholing)."""
    ticks = 1500 if "faults" in overrides else tscen.scenario(name).max_ticks
    runs = {b: tscen.scenario(name, departures_backend=b, **overrides).build(device="cpu")
            .run(ticks) for b in ("kernel", "plain")}
    st = runs["kernel"]
    assert bool(st.done.all()) if not overrides else int(st.m.n_black) > 0
    _assert_states_equal(runs["kernel"], runs["plain"])


def test_unknown_departures_backend_raises():
    with pytest.raises(KeyError, match="unknown departures backend"):
        tscen.scenario("tiny_perm4", departures_backend="split").build(device="cpu")


@pytest.mark.parametrize("name,overrides,ticks", [
    ("perm_128n_3t", {}, 120),
    ("perm_128n_3t", dict(fabric_backend="split", transport_backend="split"), 120),
    ("tiny_3t", dict(algo="eqds"), 120),
    ("corefail_128n_3t", dict(algo="bbr", lb="plb"), 520),
    ("tiny_sparse", dict(faults=_sparse_with_faults(tfaults)), 1500),
], ids=["smartt", "split-arrivals-control", "eqds", "faults-bbr-plb", "leaps"])
def test_block_operands_stay_put(monkeypatch, name, overrides, ticks):
    """The kernel's block holds every operand (``PER_TICK`` is empty): over
    a run, through every other phase's backends and the leaps, they must be
    the same tensors each tick (else the wrapper would rebuild the block
    every tick), and no operand the phase writes may share storage with
    another."""
    seen = []
    plain = DR.departures_ref

    def record(t, lat, fl, o):
        seen.append(tuple(x for n, x in zip(o._fields, o) if n not in DK.PER_TICK))
        ptrs = {n: x.untyped_storage().data_ptr() for n, x in zip(o._fields, o)}
        for n in ("q_head", "q_size", "infl", "n_black"):
            assert [m for m, p in ptrs.items() if p == ptrs[n]] == [n], n
        return plain(t, lat, fl, o)
    monkeypatch.setattr(DR, "departures_ref", record)
    sim = tscen.scenario(name, departures_backend="plain", **overrides).build(device="cpu")
    sim.run(ticks)
    assert len(seen) == sim.stats["steps"] > 10
    assert all(all(a is b for a, b in zip(seen[0], s)) for s in seen[1:])
