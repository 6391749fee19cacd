"""PyTorch port, the arrivals phase: ``kernels/arrivals``'s plain versions
against the JAX package's ``fabric.arrivals``, one phase at a time from
reference-dumped states.

The reference is driven tick by tick (``test_torch_tick._reference_pairs``);
at each chosen tick its departures phase gives the state the arrivals phase
starts from, and its arrivals phase the state it must end in.  The port's
arrivals phase (``arrivals_ref`` on the CPU, the fused kernel's contract)
runs from the first: every leaf exact, f32 ones included (the phase's f32
sums add whole packet sizes).

Besides: ``arrivals_by_owner`` (the kernel's formulation) equals
``arrivals_ref`` on every seeded ``arrivals_case``; the three
``fabric_backend`` values give identical whole runs; every registered
scenario gives each wire row one reader; and the operands the kernel's run
block holds (all but ``fault_active``, the queue heads and sizes among
them) are the same tensors every tick of a run.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch.kernels import cases  # noqa: E402
from repro_torch.kernels.arrivals import kernel as AK  # noqa: E402
from repro_torch.kernels.arrivals import ref as AR  # noqa: E402
from repro_torch.netsim import scenarios as tscen  # noqa: E402
from repro_torch.netsim import state as tstate  # noqa: E402
from repro_torch.netsim.topology import build_topology  # noqa: E402
from test_torch_control import _assert_states_equal  # noqa: E402
from test_torch_engine import one_torch_thread  # noqa: E402,F401 (autouse)
from test_torch_tick import _leaves, _reference_pairs  # noqa: E402


def _phase(sim, name):
    return dict(sim.phases)[name]


def check_arrivals_phase(name, forced=(), **overrides):
    """The port's arrivals phase from the reference's pre-arrivals state at
    each chosen tick; returns the kinds of arrivals work seen."""
    jsim, pairs = _reference_pairs(name, forced, **overrides)
    jdep, jarr = (jax.jit(lambda st, f=_phase(jsim, n): f(jsim.consts, st))
                  for n in ("departures", "arrivals"))
    tsim = tscen.scenario(name, **overrides).build(device="cpu")
    tarr = _phase(tsim, "arrivals")
    kinds = set()
    for t, st_t, _, _, _ in pairs:
        pre = jdep(st_t)
        want = jax.tree.map(np.asarray, jarr(pre))
        pre = jax.tree.map(np.asarray, pre)
        kinds |= {k for k, v in {
            "deliver": want.m.delivered_pkts > pre.m.delivered_pkts,
            "done": (want.done & ~pre.done).any(),
            "enqueue": (want.q_size[:-1] > pre.q_size[:-1]).any(),
            "trim": want.m.n_trim > pre.m.n_trim,
            "drop": want.m.n_drop > pre.m.n_drop,
            "trim_seen": (want.trim_seen != pre.trim_seen).any(),
            "goodput_hist": (want.m.goodput_hist != pre.m.goodput_hist).any(),
            "bytes_fault": want.m.delivered_bytes_fault > pre.m.delivered_bytes_fault,
        }.items() if v}
        clk = tsim.clock0._replace(t=t)
        got = tstate.to_numpy(tarr(tsim.consts, tstate.from_numpy(pre, "cpu"), clk))
        for (n, a), (_, b) in zip(_leaves(want), _leaves(got)):
            assert a.dtype == b.dtype and a.shape == b.shape, (name, t, n)
            assert a.tobytes() == b.tobytes(), f"{name} t={t} {n}"
    print(f"{name} {overrides}: arrivals phase at ticks {[p[0] for p in pairs]}, "
          f"work {sorted(kinds)}")
    return kinds, [p[0] for p in pairs]


@pytest.mark.parametrize("name,forced,overrides,needs", [
    ("perm_128n_3t", (), {}, {"deliver", "done", "enqueue", "trim"}),
    ("alltoall16_w4", (), {}, {"deliver", "enqueue"}),
    ("incast8_16n", (), dict(trimming=False), {"deliver", "enqueue", "drop"}),
    ("incast8_16n", (), dict(algo="eqds"), {"deliver", "trim", "trim_seen"}),
    ("corefail_128n_3t", (499, 500, 501, 520), dict(max_ticks=540),
     {"deliver", "trim", "goodput_hist", "bytes_fault"}),
], ids=["perm_128n_3t", "alltoall16_w4", "drops", "eqds", "corefail"])
def test_arrivals_phase_matches_reference(name, forced, overrides, needs):
    kinds, ticks = check_arrivals_phase(name, forced, **overrides)
    assert needs <= kinds, (needs - kinds)
    assert set(forced) <= set(ticks)


def _operand_leaves(o):
    return [(n, x) for n, x in zip(o._fields, o) if x is not None]


@pytest.mark.parametrize("shape,seed,flags", cases.ARRIVALS_CASES)
def test_arrivals_by_owner_equals_ref(shape, seed, flags):
    """The kernel's formulation (one reader a wire row, per switch row and
    per node) computes the contract's function on seeded operands: every
    operand bit for bit, and the cases take the branches they are for."""
    c = cases.arrivals_case(*shape, seed, **flags)
    t, s, fl, ref = cases.arrivals_operands(c, "cpu")
    _, _, _, own = cases.arrivals_operands(c, "cpu")
    _, _, _, before = cases.arrivals_operands(c, "cpu")
    AR.arrivals_ref(t, s, fl, ref)
    AR.arrivals_by_owner(t, s, fl, own)
    for (n, a), (_, b) in zip(_operand_leaves(ref), _operand_leaves(own)):
        assert a.dtype == b.dtype and a.numpy().tobytes() == b.numpy().tobytes(), n
    assert not ref.infl[s.wire].any() and ref.infl.sum() != 0      # slot zeroed
    assert not ref.q_fields[-1].any()                               # write-off row
    rejects = int(ref.n_trim + ref.n_drop) - int(before.n_trim + before.n_drop)
    if shape[0] > 1:
        assert rejects > 0 and int(ref.delivered_pkts) > int(before.delivered_pkts)
        assert bool((ref.done & ~before.done).any())
        assert (ref.q_size != before.q_size).any()
        assert (fl.credit_based and fl.trimming) <= bool((ref.trim_ring != before.trim_ring).any())
        assert fl.credit_based == bool((ref.trim_seen != before.trim_seen).any())


def test_arrivals_case_rejects_one_flow_in_two_rows():
    """Flow 0's three rejects (two in row 0, one in the last row) all reach
    its trim-ledger row: count, bytes and loss words."""
    c = cases.arrivals_case(4, 6, 8, 12, 10, 3)
    t, s, fl, o = cases.arrivals_operands(c, "cpu")
    row0 = o.trim_ring[s.trim, 0].clone()
    AR.arrivals_ref(t, s, fl, o)
    assert int(o.trim_ring[s.trim, 0, 0] - row0[0]) >= 3


@pytest.mark.parametrize("name", ["tiny_3t", "perm_128n_3t"])
def test_fabric_backends_give_identical_runs(name):
    """``"kernel"`` (arrivals_ref on the CPU), ``"plain"`` and ``"split"``
    (the enqueue_rank plain version with the PyTorch glue) end in the same
    state, bit for bit."""
    sc = tscen.scenario(name)
    runs = {b: tscen.scenario(name, fabric_backend=b).build(device="cpu")
            .run(sc.max_ticks) for b in ("kernel", "plain", "split")}
    assert bool(runs["kernel"].done.all())
    _assert_states_equal(runs["kernel"], runs["plain"])
    _assert_states_equal(runs["kernel"], runs["split"])


@pytest.mark.parametrize("name", tscen.names())
def test_every_scenario_gives_each_wire_row_one_reader(name):
    tree = tscen.scenario(name).cfg.tree
    tstate.check_wire_rows(build_topology(tree), tree.n_nodes)


def test_wire_rows_without_one_reader_raise():
    tree = tscen.scenario("tiny_3t").cfg.tree
    topo = build_topology(tree)
    tbl = np.array(topo.in_tbl)
    tbl[tbl == 0] = 1                                   # emitter 1 named twice
    with pytest.raises(ValueError, match="one reader"):
        tstate.check_wire_rows(dataclasses.replace(topo, in_tbl=tbl), tree.n_nodes)
    with pytest.raises(ValueError, match="one reader"):
        tstate.check_wire_rows(dataclasses.replace(topo, enq_ids=np.array(topo.enq_ids)[1:]),
                               tree.n_nodes)


@pytest.mark.parametrize("name,overrides,ticks", [
    ("perm_128n_3t", {}, 120),
    ("perm_128n_3t", dict(departures_backend="plain", transport_backend="split"), 120),
    ("tiny_3t", dict(algo="eqds"), 120),
    ("corefail_128n_3t", {}, 520),
], ids=["smartt", "plain-departures-split-control", "eqds", "faults"])
def test_run_block_operands_stay_put(monkeypatch, name, overrides, ticks):
    """The fused kernel's run block holds every operand but
    ``fault_active``: over a run those must be the same tensors each tick
    (else the wrapper would rebuild the block every tick).  The departures
    phase updates the queue heads and sizes in place, so they are among
    them."""
    seen = []
    plain = AR.arrivals_ref

    def record(t, s, fl, o, **kw):
        seen.append(AK._stable(o))
        return plain(t, s, fl, o, **kw)
    monkeypatch.setattr(AR, "arrivals_ref", record)
    sim = tscen.scenario(name, fabric_backend="plain", **overrides).build(device="cpu")
    sim.run(ticks)
    assert len(seen) == sim.stats["steps"] > 10
    assert all(all(a is b for a, b in zip(seen[0], x)) for x in seen[1:])
