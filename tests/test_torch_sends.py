"""PyTorch port, the sends phase: ``kernels/sends``'s plain versions
against the JAX package's ``sender.sends``, one phase at a time from
reference-dumped states.

The reference is driven tick by tick (``_send_ticks``: the ticks that
send); at each chosen tick its departures, arrivals, control and grants phases
give the state the sends phase starts from, and its sends phase the state
it must end in.  The port's sends phase (``sends_ref`` on the CPU, the
fused kernel's contract) runs from the first: every leaf exact, f32 ones
included (the phase's f32 work is single adds, subtracts and compares).
This file holds the SMaRTT runs; ``test_torch_sends_options.py`` the
baselines and the other load balancers.

Besides: ``sends_by_sender`` (the kernel's formulation) equals
``sends_ref`` on every seeded ``sends_case``; the three ``sender_backend``
values give identical whole runs; an unknown backend raises; and the
operands the kernel's run block holds are the same tensors every tick,
none sharing storage with another.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.netsim import engine as jengine  # noqa: E402
from repro.netsim import metrics as jmetrics  # noqa: E402
from repro.netsim import scenarios as jscen  # noqa: E402
from repro_torch.kernels import cases  # noqa: E402
from repro_torch.kernels.sends import kernel as SK  # noqa: E402
from repro_torch.kernels.sends import ref as SR  # noqa: E402
from repro_torch.netsim import scenarios as tscen  # noqa: E402
from repro_torch.netsim import state as tstate  # noqa: E402
from test_torch_control import _assert_states_equal  # noqa: E402
from test_torch_engine import one_torch_thread  # noqa: E402,F401 (autouse)
from test_torch_tick import _leaves  # noqa: E402

BEFORE_SENDS = ("departures", "arrivals", "control", "grants")


def _phase(sim, name):
    return dict(sim.phases)[name]


def _send_ticks(name, forced=(), **overrides):
    """Run the reference tick by tick (leaping idle stretches as its run
    loop does) and keep the start-of-tick state, as numpy, of the ticks in
    ``forced``, of the first tick that sends, retransmits or moves a
    cursor, and of every sending tick on a stride of about 1/24 of the
    scenario's tick budget."""
    sc = jscen.scenario(name, **overrides)
    sim = jengine.build(sc.cfg, sc.wl)
    step, horizon = jax.jit(sim.step), jax.jit(sim.horizon)
    stride = max(1, sc.max_ticks // 24)
    st, t, seen, kept = sim.init(), 0, set(), []
    while t < sc.max_ticks and not bool(jnp.all(st.done)):
        h = int(horizon(st))
        if sim.dims.leap and h > 0 and t not in forced:
            d = min([h, sc.max_ticks - t] + [f - t for f in forced if f > t])
            occ = jnp.sum(st.q_size[:-1])
            st = st._replace(now=st.now + d,
                             m=jmetrics.leap_account(st.m, jnp.int32(d), occ))
            t += d
            continue
        st1 = step(st)
        kinds = {k for k, v in {
            "send": bool(jnp.any(st1.next_seq != st.next_seq)),
            "retx": int(st1.m.n_retx) > int(st.m.n_retx),
            "pick": bool(jnp.any(st1.rr_send != st.rr_send)),
        }.items() if v}
        if t in forced or kinds - seen or (kinds and t % stride == 0):
            kept.append((t, jax.tree.map(np.asarray, st)))
        seen |= kinds
        st, t = st1, t + 1
    return sim, kept


def check_sends_phase(name, forced=(), **overrides):
    """The port's sends phase from the reference's pre-sends state at each
    chosen tick; returns the kinds of sends work seen."""
    jsim, pairs = _send_ticks(name, forced, **overrides)
    jpre = [jax.jit(lambda st, f=_phase(jsim, n): f(jsim.consts, st)) for n in BEFORE_SENDS]
    jsends = jax.jit(lambda st: _phase(jsim, "sends")(jsim.consts, st))
    tsim = tscen.scenario(name, **overrides).build(device="cpu")
    tsends = _phase(tsim, "sends")
    kinds = set()
    NQ = tsim.dims.NQ
    for t, st_t in pairs:
        pre = st_t
        for f in jpre:
            pre = f(pre)
        want = jax.tree.map(np.asarray, jsends(pre))
        pre = jax.tree.map(np.asarray, pre)
        w = (t + int(jsim.consts.lat_send)) % tsim.dims.L
        kinds |= {k for k, v in {
            "emit": want.infl[w, NQ:, 0].any(),
            "retx": want.m.n_retx > pre.m.n_retx,
            "pick": (want.rr_send != pre.rr_send).any(),
            "credit": (want.cc.credits != pre.cc.credits).any(),
            "spec": (want.cc.spec_budget != pre.cc.spec_budget).any(),
            "pace": (want.pace_accum != pre.pace_accum).any(),
            "explore": (want.lb.explore_sent != pre.lb.explore_sent).any(),
            "spray": (want.lb.spray_ctr != pre.lb.spray_ctr).any(),
        }.items() if v}
        clk = tsim.clock0._replace(t=t)
        got = tstate.to_numpy(tsends(tsim.consts, tstate.from_numpy(pre, "cpu"), clk))
        for (n, a), (_, b) in zip(_leaves(want), _leaves(got)):
            assert a.dtype == b.dtype and a.shape == b.shape, (name, t, n)
            assert a.tobytes() == b.tobytes(), f"{name} t={t} {n}"
    print(f"{name} {overrides}: sends phase at ticks {[p[0] for p in pairs]}, "
          f"work {sorted(kinds)}")
    return kinds, [p[0] for p in pairs]


@pytest.mark.parametrize("name,forced,needs", [
    ("perm_128n_3t", (70,), {"emit", "retx", "explore"}),
    ("tiny_sparse", (), {"emit", "pick"}),
    ("alltoall16_w4", (), {"emit", "pick", "explore"}),
    ("tiny_allreduce_ring", (), {"emit", "pick"}),
], ids=["perm_128n_3t", "tiny_sparse", "alltoall16_w4", "tiny_allreduce_ring"])
def test_sends_phase_matches_reference(name, forced, needs):
    kinds, ticks = check_sends_phase(name, forced)
    assert needs <= kinds, (needs - kinds)
    assert set(forced) <= set(ticks)


def _operand_leaves(o):
    return [(n, x) for n, x in zip(o._fields, o)]


@pytest.mark.parametrize("shape,seed,flags", cases.SENDS_CASES)
def test_sends_by_sender_equals_ref(shape, seed, flags):
    """The kernel's formulation (a sender row 32 slots at a time, the
    winner emits) computes the contract's function on seeded operands:
    every operand bit for bit, and the cases take the branches they are
    for."""
    c = cases.sends_case(*shape, seed, **flags)
    t, wire, fl, ref = cases.sends_operands(c, "cpu")
    _, _, _, own = cases.sends_operands(c, "cpu")
    _, _, _, before = cases.sends_operands(c, "cpu")
    SR.sends_ref(t, wire, fl, ref)
    SR.sends_by_sender(t, wire, fl, own)
    for (n, a), (_, b) in zip(_operand_leaves(ref), _operand_leaves(own)):
        assert a.dtype == b.dtype and a.numpy().tobytes() == b.numpy().tobytes(), n
    N, FMAX = ref.flows_of.shape
    nic = ref.infl[wire, -N:]
    emitted = nic[:, 0] == 1
    assert emitted.any() and not nic[~emitted].any()          # idle NICs zeroed
    assert bool((ref.infl[wire, :-N] == before.infl[wire, :-N]).all())
    assert bool((ref.sent[:, -1] == before.sent[:, -1]).all())  # the write-off row
    assert int(ref.n_retx - before.n_retx) >= min(3, int(emitted.sum()))
    assert (FMAX > 1) == bool((ref.rr_send != before.rr_send).any())
    assert fl.credit_based == bool((ref.credits != before.credits).any())
    assert fl.paced == bool((ref.pace_accum != before.pace_accum).any())


@pytest.mark.parametrize("shape,seed,flags", [
    c for c in cases.SENDS_CASES if c[0][0] > 4])
def test_sends_case_special_rows(shape, seed, flags):
    """The case's special rows: the flows picked by their cursors resend
    the sequence of ring slot 0, of slot 40, and of the first of two
    pending slots; the fourth row's pick wraps below its cursor."""
    c = cases.sends_case(*shape, seed, **flags)
    t, wire, fl, o = cases.sends_operands(c, "cpu")
    rr0 = o.rr_send.clone()
    SR.sends_ref(t, wire, fl, o)
    N, NF = o.flows_of.shape[0], o.src.shape[0]
    cnt = (o.flows_of < NF).sum(dim=1).tolist()
    rows = [s for s in range(N) if cnt[s]][:3]
    rows += [s for s in range(N) if cnt[s] > 1 and s not in rows][:1]
    for s, slot in zip(rows[:3], (0, min(40, shape[3] - 1), 7)):
        f = int(o.infl[wire, -N + s, 2])
        assert int(o.infl[wire, -N + s, 0]) == 1 and f == int(o.flows_of[s, rr0[s]])
        assert int(np.flatnonzero(c["sent"][0, f] == 3)[0]) == slot
        assert int(o.infl[wire, -N + s, 3]) == int(c["sent"][1, f, slot])
    if shape[1] > 1:                                        # the wrapping row
        s = rows[3]
        assert int(o.infl[wire, -N + s, 0]) == 1 and int(o.rr_send[s]) <= int(rr0[s])


@pytest.mark.parametrize("name", ["tiny_sparse", "alltoall16_w4"])
def test_sender_backends_give_identical_runs(name):
    """``"kernel"`` (sends_ref on the CPU), ``"plain"`` and ``"split"``
    (the rr_pick plain version with the PyTorch glue) end in the same
    state, bit for bit."""
    sc = tscen.scenario(name)
    runs = {b: tscen.scenario(name, sender_backend=b).build(device="cpu")
            .run(sc.max_ticks) for b in ("kernel", "plain", "split")}
    assert bool(runs["kernel"].done.all())
    _assert_states_equal(runs["kernel"], runs["plain"])
    _assert_states_equal(runs["kernel"], runs["split"])


def test_unknown_sender_backend_raises():
    with pytest.raises(KeyError, match="unknown sender backend"):
        tscen.scenario("tiny_perm4", sender_backend="pallas").build(device="cpu")


@pytest.mark.parametrize("name,overrides", [
    ("tiny_sparse", {}),
    ("perm_128n_3t", dict(transport_backend="split")),
    ("tiny_3t", dict(algo="eqds")),
    ("tiny_3t", dict(algo="bbr", lb="plb")),
    ("tiny_incast3", dict(lb="spray", evict_on_timeout=True, trimming=False)),
], ids=["smartt", "split-control", "eqds", "bbr-plb", "spray-evict"])
def test_run_block_operands_stay_put(monkeypatch, name, overrides):
    """The fused kernel's run block holds every operand but ``PER_TICK``'s:
    over a run those must be the same tensors each tick (else the wrapper
    would rebuild the block every tick), and no operand the phase writes
    may share storage with another operand."""
    seen = []
    plain = SR.sends_ref

    def record(t, wire, fl, o, **kw):
        seen.append(SK._stable(o))
        written = ("sent", "infl", "next_seq", "rr_send", "pace_accum", "credits",
                   "spec_budget", "next_entropy", "explore_sent", "spray_ctr", "n_retx")
        ptrs = {n: x.untyped_storage().data_ptr() for n, x in zip(o._fields, o)}
        for n in written:
            assert [m for m, p in ptrs.items() if p == ptrs[n]] == [n], n
        return plain(t, wire, fl, o, **kw)
    monkeypatch.setattr(SR, "sends_ref", record)
    sim = tscen.scenario(name, sender_backend="plain", **overrides).build(device="cpu")
    sim.run(120)
    assert len(seen) == sim.stats["steps"] > 10
    assert all(all(a is b for a, b in zip(seen[0], s)) for s in seen[1:])
