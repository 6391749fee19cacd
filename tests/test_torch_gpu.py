"""PyTorch port on a CUDA card: each hand-written kernel against its plain
PyTorch version (bit for bit, at the main path's shapes and ragged
ones; the fused departures, control, arrivals and sends phases also on
simulator states at chosen ticks), and small scenarios through the kernels against the same
runs on the CPU (final states bit for bit, one launch of each tick kernel
per executed tick).

Every test is marked ``gpu`` and skips without a card; whether there is
one is decided inside the fixture.  This file imports no JAX, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import cases  # noqa: E402
from repro_torch.kernels.arrivals import kernel as AK  # noqa: E402
from repro_torch.kernels.arrivals import ref as AR  # noqa: E402
from repro_torch.kernels.cc_update import kernel as CK  # noqa: E402
from repro_torch.kernels.cc_update import ref as CR  # noqa: E402
from repro_torch.kernels.control import kernel as XK  # noqa: E402
from repro_torch.kernels.control import ref as XR  # noqa: E402
from repro_torch.kernels.departures import kernel as PK  # noqa: E402
from repro_torch.kernels.departures import ref as PR  # noqa: E402
from repro_torch.kernels.enqueue_arb import kernel as EK  # noqa: E402
from repro_torch.kernels.enqueue_arb import ref as ER  # noqa: E402
from repro_torch.kernels.red_mark import kernel as RK  # noqa: E402
from repro_torch.kernels.red_mark import ref as RR  # noqa: E402
from repro_torch.kernels.ring_drain import kernel as DK  # noqa: E402
from repro_torch.kernels.ring_drain import ref as DR  # noqa: E402
from repro_torch.kernels.sends import kernel as SK  # noqa: E402
from repro_torch.kernels.sends import ref as SR  # noqa: E402
from repro_torch.netsim import fabric, scenarios, sender  # noqa: E402
from repro_torch.netsim import faults as tfaults  # noqa: E402
from repro_torch.netsim import state as tstate  # noqa: E402
from repro_torch.netsim import transport  # noqa: E402

pytestmark = pytest.mark.gpu

# main-path shapes: perm_1024n_3t and alltoall_3t
NF, NSW, DMAX, NQ, CAP, W, MAXW = 1024, 176, 20, 2304, 40, 64, 2
N_A2A, FMAX_A2A = 512, 31
DRAIN_IN = ("rto", "started", "has_ack", "ack_seq", "lbits", "bitmap",
            "sent0", "sent1", "sent2")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _on(a, dev):
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def _bit_equal(a, b):
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("F,seed,react", [(1, 1, 1), (7, 2, 3), (1000, 3, 1),
                                          (NF, 4, 1)])
def test_cc_update_kernel_bit_equal(cuda, F, seed, react):
    p, s, ev, now = cases.cc_update_tensors(cases.cc_update_case(F, seed, react), cuda)
    for k, r in zip(CK.cc_update(p, s, ev, now), CR.cc_update_ref(p, s, ev, now)):
        assert _bit_equal(k, r)


@pytest.mark.parametrize("shape,seed", [((1, 1, 4, 3), 1), ((3, 5, 7, 4), 2),
                                        ((NSW, DMAX, NQ, CAP), 3)])
def test_enqueue_rank_kernel_bit_equal(cuda, shape, seed):
    S, D, nq, cap = shape
    c = cases.enqueue_rank_case(S, D, nq, cap, seed)
    args = [_on(c[n], cuda) for n in ("gdst", "ghead", "gsize")]
    for k, r in zip(EK.enqueue_rank(*args, cap=cap, nq=nq),
                    ER.enqueue_rank_ref(*args, cap=cap, nq=nq)):
        assert _bit_equal(k, r)


@pytest.mark.parametrize("shape,seed", [((1, 1), 1), ((5, 33), 2), ((7, 64), 3),
                                        ((N_A2A, FMAX_A2A), 4)])
def test_rr_pick_kernel_bit_equal(cuda, shape, seed):
    N, K = shape
    c = cases.rr_pick_case(N, K, seed)
    e, rr = _on(c["elig"], cuda), _on(c["rr"], cuda)
    for k, r in zip(EK.rr_pick(e, rr, kmax=K), ER.rr_pick_ref(e, rr, kmax=K)):
        assert _bit_equal(k, r)


@pytest.mark.parametrize("shape,seed", [((3, 32, 1), 1), ((2, 1024, 40), 2),
                                        ((NF, W, MAXW), 3)])
def test_ring_drain_kernel_bit_equal(cuda, shape, seed):
    F, w, maxw = shape
    c = cases.ring_drain_case(F, w, maxw, seed)
    a = {n: _on(c[n], cuda) for n in DRAIN_IN}
    # the loss words as the transport hands them: a row-strided view
    a["lbits"] = torch.cat([torch.zeros((F, 2), dtype=torch.int32, device=cuda),
                            a["lbits"]], dim=1)[:, 2:]
    args = [a[n] for n in DRAIN_IN]
    for k, r in zip(DK.ring_drain(c["t"], *args),
                    DR.ring_drain_ref(c["t"], *args, w=w, ww=w // 32, maxw=maxw)):
        assert _bit_equal(k, r)


@pytest.mark.parametrize("Q,tick,salt,kmin,kmax", [
    (1, 0, 0xECD, 8.0, 32.0), (130, 65535, -7, 5.2, 20.8),
    (NQ, 120000, 0xECD, 8.0, 32.0), (NQ, 2 ** 24 + 1, 2 ** 24 + 3, 8.0, 32.0),
    (NQ, 99, 0xECD, 20.0, 20.0)])
def test_red_mark_kernel_bit_equal(cuda, Q, tick, salt, kmin, kmax):
    c = cases.red_mark_case(Q, seed=Q + tick)
    qs, ar = _on(c["q_size"], cuda), _on(c["arrivals"], cuda)
    lo, hi = (torch.tensor(v, dtype=torch.float32, device=cuda) for v in (kmin, kmax))
    got = RK.red_mark(qs, ar, cap=c["cap"], kmin=kmin, kmax=kmax, tick=tick, salt=salt)
    for k, r in zip(got, RR.red_mark_ref(qs, ar, c["cap"], lo, hi, tick, salt)):
        assert _bit_equal(k, r)
    assert got[0].any() or Q == 1


def test_kernel_wrappers_refuse_bad_operands(cuda):
    c = cases.rr_pick_case(8, 4, 0)
    e, rr = _on(c["elig"], cuda), _on(c["rr"], cuda)
    with pytest.raises(TypeError, match="dtype"):
        EK.rr_pick(e.to(torch.int32), rr, kmax=4)
    with pytest.raises(ValueError, match="shape"):
        EK.rr_pick(e, rr[:4], kmax=4)
    with pytest.raises(ValueError, match="contiguous"):
        EK.rr_pick(e.t().contiguous().t(), rr, kmax=4)
    with pytest.raises(ValueError, match="on cpu"):
        EK.rr_pick(e, rr.cpu(), kmax=4)


@pytest.mark.parametrize("name", ["tiny_sparse", "perm_128n_3t"])
def test_scenario_through_kernels_equals_cpu(cuda, name):
    """A whole run through the kernels on the card ends in the CPU port's
    final state, bit for bit, with one launch of each tick kernel per
    executed tick (the fused departures phase; the fused control phase,
    SMaRTT inside it; the fused arrivals and sends phases, the sends' pick inside it where senders hold
    several flows; the split designs' enqueue_rank, cc_update, ring_drain
    and rr_pick never)."""
    sc = scenarios.scenario(name)
    sim = sc.build(device=cuda)
    fns = (PK.departures, XK.control, AK.arrivals, SK.sends, EK.enqueue_rank,
           CK.cc_update, DK.ring_drain, EK.rr_pick)
    for fn in fns:
        fn.launches = 0
    XK.control.launches_smartt = 0
    st = sim.run(sc.max_ticks)
    torch.cuda.synchronize()
    steps = sim.stats["steps"]
    assert [fn.launches for fn in fns] == [steps, steps, steps, steps, 0, 0, 0, 0]
    assert XK.control.launches_smartt == steps
    cpu = sc.build(device="cpu")
    ref = cpu.run(sc.max_ticks)
    a, b = tstate.to_numpy(st), tstate.to_numpy(ref)

    def leaves(t, p=""):
        if hasattr(t, "_fields"):
            for n, v in zip(t._fields, t):
                yield from leaves(v, f"{p}.{n}" if p else n)
        else:
            yield p, t
    for (n, x), (_, y) in zip(leaves(a), leaves(b)):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), n


@pytest.mark.parametrize("name,overrides,ticks,on_path", [
    ("incast8_16n", dict(algo="eqds"), None,
     ("departures", "arrivals", "control", "rr_pick", "sends")),
    ("corefail_128n_3t", {}, 700, ("departures", "arrivals", "control", "sends")),
    ("perm_128n_3t", dict(fabric_backend="split"), None,
     ("departures", "enqueue_rank", "control", "sends")),
    ("tiny_sparse", dict(sender_backend="split"), None,
     ("departures", "arrivals", "control", "rr_pick")),
    ("perm_128n_3t", dict(algo="bbr", lb="spray"), 300,
     ("departures", "arrivals", "control", "sends")),
    ("flap_128n_3t", dict(departures_backend="plain"), 700, ("arrivals", "control", "sends")),
], ids=["eqds", "corefail", "split-arrivals", "split-sends", "paced-spray",
        "plain-departures"])
def test_comparison_run_through_kernels_equals_cpu(cuda, name, overrides, ticks, on_path):
    """EQDS (credit grants through rr_pick, the fused control phase with
    the CC update off, the fused arrivals and sends phases on the credit
    path), a fault schedule (corefail_128n_3t to tick 700, past the failure
    at 500 and its first timeouts, SMaRTT inside the fused control phase,
    the fault metrics inside the fused arrivals phase), the split designs
    of the arrivals phase (the enqueue_rank kernel once a tick) and of the
    sends phase (the rr_pick kernel once a tick), BBR's pacing with
    spraying through the fused sends phase, and flap_128n_3t with the
    departures phase in PyTorch (``departures_backend="plain"``, its
    earlier design), through the kernels on the card end in the CPU port's
    state."""
    sc = scenarios.scenario(name, **overrides)
    ticks = ticks or sc.max_ticks
    sim = sc.build(device=cuda)
    fns = {"cc_update": CK.cc_update, "enqueue_rank": EK.enqueue_rank,
           "ring_drain": DK.ring_drain, "rr_pick": EK.rr_pick, "control": XK.control,
           "arrivals": AK.arrivals, "sends": SK.sends, "departures": PK.departures}
    for fn in fns.values():
        fn.launches = 0
    XK.control.launches_smartt = 0
    st = sim.run(ticks)
    torch.cuda.synchronize()
    steps = sim.stats["steps"]
    assert {k: fn.launches for k, fn in fns.items()} == \
        {k: steps if k in on_path else 0 for k in fns}
    assert XK.control.launches_smartt == (steps if sc.cfg.algo == "smartt" else 0)
    ref = scenarios.scenario(name, **{**overrides, "fabric_backend": "kernel",
                                      "sender_backend": "kernel",
                                      "departures_backend": "kernel"}).build(
        device="cpu").run(ticks)
    a, b = tstate.to_numpy(st), tstate.to_numpy(ref)
    for x, y in zip(_leaf_list(a), _leaf_list(b)):
        assert x[1].dtype == y[1].dtype and x[1].tobytes() == y[1].tobytes(), x[0]
    if name in ("corefail_128n_3t", "flap_128n_3t"):
        assert int(st.m.n_black) > 0 and float(st.m.delivered_bytes_fault) > 0


def _leaf_list(t, p=""):
    if hasattr(t, "_fields"):
        return [x for n, v in zip(t._fields, t)
                for x in _leaf_list(v, f"{p}.{n}" if p else n)]
    return [(p, t)]


# ------------------------------------------------ the fused control phase


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return type(tree)(*(_clone(x) for x in tree))


def _control_both(t, fl, ok, orf):
    """The fused kernel on ``ok`` and its plain version on ``orf`` (two
    copies of the same operands); both events and both operand sets must
    be equal bit for bit.  Returns the kernel's event."""
    n0 = XK.control.launches
    evk = XK.control_at(t, fl, ok)
    evr = XR.control_ref(t, fl, orf)
    torch.cuda.synchronize()
    assert XK.control.launches == n0 + 1
    for name, a, b in zip(evk._fields, evk, evr):
        assert _bit_equal(a, b), name
    for (n, a), (_, b) in zip(_leaf_list(ok), _leaf_list(orf)):
        assert _bit_equal(a, b), n
    return evk


@pytest.mark.parametrize("shape,seed,flags", [
    ((1, 1, 32, 1, 3), 2, {}),
    ((13, 5, 1024, 40, 9), 2, dict(smartt=False, credit_based=True)),
    ((NF, NF, W, MAXW, 40), 3, dict(rto_backoff_max=3)),
    ((NF, NF, W, MAXW, 40), 4, dict(trimming=False, credit_based=True,
                                     rto_backoff_max=2, smartt=False)),
    ((N_A2A, 32, W, 1, 40), 5, dict(credit_based=True)),
], ids=["one-flow", "ragged-w1024", "perm1024-backoff", "no-trim-credit", "many-per-node"])
def test_control_kernel_bit_equal(cuda, shape, seed, flags):
    c = cases.control_case(*shape, seed, **flags)
    t, fl, ok = cases.control_operands(c, cuda)
    _, _, orf = cases.control_operands(c, cuda)
    ev = _control_both(t, fl, ok, orf)
    assert bool(ev.has_ack.any()) and int(ev.n_timeouts.sum()) > 0
    # the slots are zero after the call, the sentinel rows included
    s = t % c["ack_ring"].shape[0]
    assert not ok.ack_ring[s].any() and not ok.trim_ring[s].any() \
        and not ok.credit_ring[s].any()


@pytest.mark.parametrize("name,overrides,ticks", [
    ("perm_128n_3t", {}, (40, 70, 120, 200, 300)),
    ("incast8_16n", dict(rto_backoff_max=3, trimming=False, evict_on_timeout=True),
     tuple(range(40, 140))),
    ("tiny_incast3", dict(algo="eqds"), tuple(range(4, 20))),
], ids=["perm_128n_3t", "timeouts-backoff", "eqds"])
def test_control_kernel_bit_equal_on_tick_states(cuda, name, overrides, ticks):
    """The simulator's own states on the card: at each chosen tick, after
    departures and arrivals, the fused kernel and its plain version from
    two copies of the state agree bit for bit."""
    sc = scenarios.scenario(name, **overrides)
    sim = sc.build(device=cuda)
    fl = transport.flags(sc.cfg, sim.dims)
    phases = dict(sim.phases)
    st = sim.init()
    seen = set()
    for t in range(max(ticks) + 1):
        clk = sim.clock0._replace(t=t)
        for name_ in ("departures", "arrivals"):
            st = phases[name_](sim.consts, st, clk)
        if t in ticks:
            a, b = _clone(st), _clone(st)
            ev = _control_both(t, fl, transport.operands(sim.consts, a),
                               transport.operands(sim.consts, b))
            seen |= {k for k, v in (("ack", ev.has_ack.any()),
                                    ("timeout", ev.n_timeouts.any()),
                                    ("trim", ev.n_trims.any()),
                                    ("credit", ev.credit_grant.any())) if bool(v)}
        for name_ in ("control", "grants", "sends", "metrics"):
            st = phases[name_](sim.consts, st, clk)
        st = st._replace(now=st.now + 1)
    assert "ack" in seen
    assert ("timeout" in seen) == ("rto_backoff_max" in overrides)
    assert ("credit" in seen) == (sc.cfg.algo == "eqds")


def test_control_kernel_refuses_bad_operands(cuda):
    c = cases.control_case(16, 4, 64, 2, 8, 0)
    t, fl, o = cases.control_operands(c, cuda)
    n0 = XK.control.launches
    with pytest.raises(TypeError, match="dtype"):
        XK.control_at(t, fl, o._replace(sent=o.sent.to(torch.int64)))
    with pytest.raises(ValueError, match="shape"):
        XK.control_at(t, fl, o._replace(trim_ring=o.trim_ring[:, :, :3].contiguous()))
    with pytest.raises(ValueError, match="contiguous"):
        XK.control_at(t, fl, o._replace(bitmap=o.bitmap.t().contiguous().t()))
    with pytest.raises(ValueError, match="on cpu"):
        XK.control_at(t, fl, o._replace(done=o.done.cpu()))
    with pytest.raises(ValueError, match="multiple of 32"):
        XK.control_at(t, fl, o._replace(sent=o.sent[:, :, :48].contiguous()))
    assert XK.control.launches == n0
    XK.control_at(t, fl, o)
    assert XK.control.launches == n0 + 1


# ------------------------------------------------ the fused arrivals phase

def _arrivals_both(t, s, fl, ok, orf):
    """The fused kernel on ``ok`` and ``arrivals_ref`` on ``orf`` (two copies
    of the same operands): every operand bit for bit."""
    n0 = AK.arrivals.launches
    AK.arrivals_at(t, s, fl, ok)
    AR.arrivals_ref(t, s, fl, orf)
    torch.cuda.synchronize()
    assert AK.arrivals.launches == n0 + 1
    for n, a, b in zip(ok._fields, ok, orf):
        if a is not None:
            assert _bit_equal(a, b), n


@pytest.mark.parametrize("shape,seed,flags", cases.ARRIVALS_CASES)
def test_arrivals_kernel_bit_equal(cuda, shape, seed, flags):
    c = cases.arrivals_case(*shape, seed, **flags)
    t, s, fl, ok = cases.arrivals_operands(c, cuda)
    _, _, _, orf = cases.arrivals_operands(c, cuda)
    _arrivals_both(t, s, fl, ok, orf)
    assert not ok.infl[s.wire].any() and not ok.q_fields[-1].any()


@pytest.mark.parametrize("name,overrides,ticks", [
    ("perm_128n_3t", {}, (40, 70, 120, 200, 300)),
    ("incast8_16n", dict(algo="eqds"), tuple(range(20, 120, 3))),
    ("incast8_16n", dict(trimming=False), tuple(range(20, 120, 3))),
    ("corefail_128n_3t", {}, (260, 270, 499, 500, 501, 520, 600)),
], ids=["perm_128n_3t", "eqds", "drops", "corefail"])
def test_arrivals_kernel_bit_equal_on_tick_states(cuda, name, overrides, ticks):
    """The simulator's own states on the card: at each chosen tick, after
    departures, the fused kernel and its plain version from two copies of
    the state agree bit for bit."""
    sc = scenarios.scenario(name, **overrides)
    sim = sc.build(device=cuda)
    phases = dict(sim.phases)
    fl = fabric.flags(sim.dims, sim.consts, sim.clock0)
    st = sim.init()
    rejects = delivered = 0
    for t in range(max(ticks) + 1):
        clk = sim.clock0._replace(t=t)
        st = phases["departures"](sim.consts, st, clk)
        if t in ticks:
            slots = AR.Slots(wire=t % sim.dims.L, ack=(t + clk.ret) % sim.dims.R,
                             trim=(t + clk.trim_delay) % sim.dims.R)
            active = tfaults.fault_active(sim.dims, sim.consts, t) if fl.faulty else None
            a, b = _clone(st), _clone(st)
            _arrivals_both(t, slots, fl, fabric.operands(sim.consts, a, active),
                           fabric.operands(sim.consts, b, active))
            rejects += int(a.m.n_trim + a.m.n_drop) - int(st.m.n_trim + st.m.n_drop)
            delivered += int(a.m.delivered_pkts) - int(st.m.delivered_pkts)
        for name_ in ("arrivals", "control", "grants", "sends", "metrics"):
            st = phases[name_](sim.consts, st, clk)
        st = st._replace(now=st.now + 1)
    assert delivered > 0 and rejects > 0


def test_arrivals_kernel_refuses_bad_operands(cuda):
    c = cases.arrivals_case(4, 6, 8, 12, 10, 0, faulty=True)
    t, s, fl, o = cases.arrivals_operands(c, cuda)
    n0 = AK.arrivals.launches
    with pytest.raises(TypeError, match="dtype"):
        AK.arrivals_at(t, s, fl, o._replace(infl=o.infl.to(torch.int64)))
    with pytest.raises(ValueError, match="shape"):
        AK.arrivals_at(t, s, fl, o._replace(ack_ring=o.ack_ring[:, :, :5].contiguous()))
    with pytest.raises(ValueError, match="contiguous"):
        AK.arrivals_at(t, s, fl, o._replace(bitmap=o.bitmap.t().contiguous().t()))
    with pytest.raises(ValueError, match="on cpu"):
        AK.arrivals_at(t, s, fl, o._replace(q_size=o.q_size.cpu()))
    with pytest.raises(TypeError, match="expected a tensor"):
        AK.arrivals_at(t, s, fl, o._replace(fault_active=None))
    with pytest.raises(ValueError, match="outside the rings"):
        AK.arrivals_at(t, s._replace(wire=o.infl.shape[0]), fl, o)
    assert AK.arrivals.launches == n0
    AK.arrivals_at(t, s, fl, o)
    assert AK.arrivals.launches == n0 + 1


# --------------------------------------------------- the fused sends phase

def _sends_both(t, wire, fl, ok, orf):
    """The fused kernel on ``ok`` and ``sends_ref`` on ``orf`` (two copies
    of the same operands): every operand bit for bit."""
    n0 = SK.sends.launches
    SK.sends_at(t, wire, fl, ok)
    SR.sends_ref(t, wire, fl, orf)
    torch.cuda.synchronize()
    assert SK.sends.launches == n0 + 1
    for n, a, b in zip(ok._fields, ok, orf):
        assert _bit_equal(a, b), n


@pytest.mark.parametrize("shape,seed,flags", cases.SENDS_CASES)
def test_sends_kernel_bit_equal(cuda, shape, seed, flags):
    c = cases.sends_case(*shape, seed, **flags)
    t, wire, fl, ok = cases.sends_operands(c, cuda)
    _, _, _, orf = cases.sends_operands(c, cuda)
    _, _, _, o0 = cases.sends_operands(c, cuda)
    _sends_both(t, wire, fl, ok, orf)
    N = ok.flows_of.shape[0]
    assert bool(ok.infl[wire, -N:, 0].any()) and int(ok.n_retx) > int(o0.n_retx)


@pytest.mark.parametrize("name,overrides,ticks", [
    ("perm_128n_3t", {}, (40, 70, 120, 200, 300)),
    ("alltoall16_w4", {}, tuple(range(10, 400, 13))),
    ("tiny_allreduce_ring", {}, tuple(range(10, 600, 17))),
    ("incast8_16n", dict(algo="eqds"), tuple(range(0, 120, 3))),
    ("perm_128n_3t", dict(algo="bbr", lb="plb"), (5, 40, 70, 120)),
], ids=["perm_128n_3t", "alltoall16_w4", "allreduce", "eqds", "bbr-plb"])
def test_sends_kernel_bit_equal_on_tick_states(cuda, name, overrides, ticks):
    """The simulator's own states on the card: at each chosen tick, after
    departures, arrivals, control and grants, the fused kernel and its
    plain version from two copies of the state agree bit for bit."""
    sc = scenarios.scenario(name, **overrides)
    sim = sc.build(device=cuda)
    phases = dict(sim.phases)
    fl = sender.flags(sim.dims)
    st = sim.init()
    emitted = 0
    for t in range(max(ticks) + 1):
        clk = sim.clock0._replace(t=t)
        for name_ in ("departures", "arrivals", "control", "grants"):
            st = phases[name_](sim.consts, st, clk)
        if t in ticks:
            wire = (t + clk.lat_send) % sim.dims.L
            a, b = _clone(st), _clone(st)
            _sends_both(t, wire, fl, sender.operands(sim.consts, a),
                        sender.operands(sim.consts, b))
            emitted += int(a.infl[wire, sim.dims.NQ:, 0].sum())
        for name_ in ("sends", "metrics"):
            st = phases[name_](sim.consts, st, clk)
        st = st._replace(now=st.now + 1)
    assert emitted > 0


def test_sends_kernel_refuses_bad_operands(cuda):
    c = cases.sends_case(8, 70, 300, 64, 3, 0, credit_based=True)
    t, wire, fl, o = cases.sends_operands(c, cuda)
    n0 = SK.sends.launches
    with pytest.raises(TypeError, match="dtype"):
        SK.sends_at(t, wire, fl, o._replace(sent=o.sent.to(torch.int64)))
    with pytest.raises(TypeError, match="dtype"):
        SK.sends_at(t, wire, fl, o._replace(f_salt=o.f_salt.to(torch.int32)))
    with pytest.raises(ValueError, match="shape"):
        SK.sends_at(t, wire, fl, o._replace(infl=o.infl[:, :, :6].contiguous()))
    with pytest.raises(ValueError, match="contiguous"):
        SK.sends_at(t, wire, fl, o._replace(flows_of=o.flows_of.t().contiguous().t()))
    with pytest.raises(ValueError, match="on cpu"):
        SK.sends_at(t, wire, fl, o._replace(next_seq=o.next_seq.cpu()))
    with pytest.raises(ValueError, match="unknown lb mode"):
        SK.sends_at(t, wire, fl._replace(lb_mode=7), o)
    with pytest.raises(ValueError, match="outside the wire ring"):
        SK.sends_at(t, o.infl.shape[0], fl, o)
    # the tick's operands are checked on every launch, the block's reused
    SK.sends_at(t, wire, fl, o)
    with pytest.raises(TypeError, match="dtype"):
        SK.sends_at(t, wire, fl, o._replace(cwnd=o.cwnd.to(torch.float64)))
    with pytest.raises(ValueError, match="contiguous"):
        SK.sends_at(t, wire, fl, o._replace(credits=torch.stack([o.credits, o.credits], 1)[:, 0]))
    with pytest.raises(ValueError, match="on cpu"):
        SK.sends_at(t, wire, fl, o._replace(next_entropy=o.next_entropy.cpu()))
    assert SK.sends.launches == n0 + 1
    SK.sends_at(t, wire, fl, o)
    assert SK.sends.launches == n0 + 2


# ----------------------------------------------- the fused departures phase

def _departures_both(t, lat, fl, ok, orf):
    """The fused kernel on ``ok`` and ``departures_ref`` on ``orf`` (two
    copies of the same operands): every operand bit for bit."""
    n0 = PK.departures.launches
    PK.departures_at(t, lat, fl, ok)
    PR.departures_ref(t, lat, fl, orf)
    torch.cuda.synchronize()
    assert PK.departures.launches == n0 + 1
    for n, a, b in zip(ok._fields, ok, orf):
        assert _bit_equal(a, b), n


@pytest.mark.parametrize("shape,seed,flags", cases.DEPARTURES_CASES)
def test_departures_kernel_bit_equal(cuda, shape, seed, flags):
    c = cases.departures_case(*shape, seed, **flags)
    t, lat, fl, ok = cases.departures_operands(c, cuda)
    _, _, _, orf = cases.departures_operands(c, cuda)
    _, _, _, o0 = cases.departures_operands(c, cuda)
    _departures_both(t, lat, fl, ok, orf)
    assert int((o0.q_size - ok.q_size).sum()) > 0
    assert bool(fl.fk or fl.flapped) == (int(ok.n_black) > int(o0.n_black))


@pytest.mark.parametrize("name,overrides,ticks", [
    ("perm_128n_3t", {}, (20, 40, 70, 120, 200)),
    ("corefail_128n_3t", {}, (499, 500, 501, 520, 680)),
    ("flap_128n_3t", {}, (150, 199, 200, 499, 500, 650)),
    ("tiny_3t", dict(faults=(("t1_up", 0, 0, 0), ("t2_down", 1, 0, 2))), tuple(range(0, 30))),
], ids=["perm_128n_3t", "corefail", "flap", "degraded"])
def test_departures_kernel_bit_equal_on_tick_states(cuda, name, overrides, ticks):
    """The simulator's own states on the card: at each chosen tick, the
    fused kernel and its plain version from two copies of the start-of-tick
    state agree bit for bit."""
    sim = scenarios.scenario(name, **overrides).build(device=cuda)
    fl = fabric.departures_flags(sim.dims)
    st = sim.init()
    emitted = 0
    for t in range(max(ticks) + 1):
        clk = sim.clock0._replace(t=t)
        if t in ticks:
            lat = PR.Lat(core=clk.lat_core, edge=clk.lat_edge)
            a, b = _clone(st), _clone(st)
            _departures_both(t, lat, fl, fabric.departures_operands(sim.consts, a),
                             fabric.departures_operands(sim.consts, b))
            emitted += int((st.q_size - a.q_size).sum())
        for _, phase in sim.phases:
            st = phase(sim.consts, st, clk)
        st = st._replace(now=st.now + 1)
    assert emitted > 0


def test_departures_kernel_refuses_bad_operands(cuda):
    c = cases.departures_case(40, 24, 30, 8, 3, 2, fk=3, flapped=True)
    t, lat, fl, o = cases.departures_operands(c, cuda)
    n0 = PK.departures.launches
    with pytest.raises(TypeError, match="dtype"):
        PK.departures_at(t, lat, fl, o._replace(q_fields=o.q_fields.to(torch.int64)))
    with pytest.raises(TypeError, match="dtype"):
        PK.departures_at(t, lat, fl, o._replace(q_salt=o.q_salt.to(torch.int32)))
    with pytest.raises(ValueError, match="shape"):
        PK.departures_at(t, lat, fl, o._replace(infl=o.infl[:, :, :6].contiguous()))
    with pytest.raises(ValueError, match="contiguous"):
        PK.departures_at(t, lat, fl, o._replace(ft_time=o.ft_time.t().contiguous().t()))
    with pytest.raises(ValueError, match="on cpu"):
        PK.departures_at(t, lat, fl, o._replace(q_size=o.q_size.cpu()))
    with pytest.raises(ValueError, match="on cpu"):
        PK.departures_at(t, lat, fl, o._replace(kspan=o.kspan.cpu()))
    with pytest.raises(ValueError, match="fault columns"):
        PK.departures_at(t, lat, fl._replace(fk=4), o)
    assert PK.departures.launches == n0
    PK.departures_at(t, lat, fl, o)
    assert PK.departures.launches == n0 + 1


# ------------------------------------------------- the lane axis (a batch)


def _lanes_pair(kind, lc_k, lc_p):
    """The batched kernel of ``kind`` on ``lc_k``, its batched plain version
    on ``lc_p``; returns their events (control) or None."""
    if kind == "departures":
        PK.departures(lc_k["tick"], lc_k["lat"], lc_k["flags"], lc_k["o"])
        PR.departures_lanes_ref(lc_p["tick"], lc_p["lat"], lc_p["flags"], lc_p["o"])
    elif kind == "arrivals":
        AK.arrivals(lc_k["tick"], lc_k["trim_delay"], lc_k["flags"], lc_k["o"], lc_k["gbin"])
        AR.arrivals_lanes_ref(lc_p["tick"], lc_p["trim_delay"], lc_p["flags"], lc_p["o"],
                              lc_p["gbin"])
    elif kind == "control":
        return (XK.control(lc_k["tick"], lc_k["flags"], lc_k["o"]),
                XR.control_lanes_ref(lc_p["tick"], lc_p["flags"], lc_p["o"]))
    else:
        SK.sends(lc_k["tick"], lc_k["lat_send"], lc_k["flags"], lc_k["o"])
        SR.sends_lanes_ref(lc_p["tick"], lc_p["lat_send"], lc_p["flags"], lc_p["o"])
    return None


@pytest.mark.parametrize("kind,shape,seed,flags", cases.LANES_CASES,
                         ids=[f"{c[0]}-{c[2]}" for c in cases.LANES_CASES])
def test_lane_batch_kernels_bit_equal(cuda, kind, shape, seed, flags):
    """Each fused kernel on a lane batch (lanes at their own ticks, one not
    live) against its batched plain version, bit for bit; one launch for
    the batch; the lane that is not live left as it was."""
    case = cases.lanes_case(kind, shape, seed, **flags)
    k, p = cases.lanes_operands(case, cuda), cases.lanes_operands(case, cuda)
    before = tstate.tree_map(lambda x: None if x is None else x.clone(), k["o"])
    fn = dict(departures=PK.departures, arrivals=AK.arrivals, control=XK.control,
              sends=SK.sends)[kind]
    n0 = fn.launches
    ev = _lanes_pair(kind, k, p)
    assert fn.launches == n0 + 1
    idle = k["tick"].live_h.index(False)
    for x, y, z in zip(tstate.tree_leaves(k["o"]), tstate.tree_leaves(p["o"]),
                       tstate.tree_leaves(before)):
        if x is not None:
            assert _bit_equal(x, y) and _bit_equal(x[idle], z[idle])
    if ev is not None:
        live = [i for i, go in enumerate(k["tick"].live_h) if go]
        for a, b in zip(*ev):
            assert _bit_equal(a[live], b[live])


@pytest.mark.parametrize("name,points,algo", [
    ("perm_128n_3t", ({}, {"start_cwnd_mult": 1.0, "kmin_frac": 0.3, "fd": 0.6},
                      {"num_entropies": 64, "rto_mult": 4.0}), "smartt"),
    ("incast8_16n", ({}, {"credit_window_mult": 1.5}), "eqds"),
], ids=["perm_128n_3t", "incast8_16n-eqds"])
def test_study_lanes_on_the_card_equal_their_runs(cuda, name, points, algo):
    """A study as one lane batch on the card: every lane's final state equal
    to its standalone run on the card and to the CPU's batch, bit for bit;
    each fused kernel launched once a batched tick."""
    from repro_torch.netsim import api
    plan = api.study(name, points=points, seeds=(0, 1), algo=algo, device=cuda)
    fns = (PK.departures, XK.control, AK.arrivals, SK.sends)
    n0 = [f.launches for f in fns]
    got = plan.run_states()
    batch = plan.sim.stats["lanes"]["batch_ticks"]
    assert [f.launches - n for f, n in zip(fns, n0)] == [batch] * 4
    cpu = api.study(name, points=points, seeds=(0, 1), algo=algo, device="cpu").run_states()
    for a, b in zip(tstate.tree_leaves(got), tstate.tree_leaves(cpu)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    sc = plan.scenario
    for lane in range(plan.n_lanes):
        pt, seed = plan.lane_point_seed(lane)
        sim = api.engine.build(api.apply_point(sc.cfg, dict(pt)), sc.wl, device=cuda)
        alone = tstate.to_numpy(sim.run(sc.max_ticks, seed=seed))
        for a, b in zip(tstate.tree_leaves(alone), tstate.tree_leaves(tstate.lane(got, lane))):
            assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("k,algo", [(2, "smartt"), (3, "smartt"), (2, "eqds")],
                         ids=["x2", "x3-padded", "x2-eqds"])
def test_study_over_the_card_repeated_equals_one_batch(cuda, k, algo):
    """A study over a mesh of the card repeated, ``[cuda] * k`` (one lane
    loop a shard, each on a thread and stream of its own): every lane's
    final state equal to the one-device batch's, bit for bit; each fused
    kernel launched the sum of the shards' batched ticks."""
    from repro_torch.netsim import api
    plan = api.study("perm_128n_3t", points=({}, {"start_cwnd_mult": 1.0, "kmin_frac": 0.3}),
                     seeds=(0, 1), algo=algo, device=cuda)
    want = plan.run_states()
    fns = (PK.departures, XK.control, AK.arrivals, SK.sends)
    n0 = [f.launches for f in fns]
    got = plan.run_states(mesh=[torch.device("cuda", 0)] * k)
    lanes = plan.sim.stats["lanes"]
    assert len(lanes["shard_ticks"]) == k and sum(lanes["shard_ticks"]) == lanes["batch_ticks"]
    assert [f.launches - n for f, n in zip(fns, n0)] == [lanes["batch_ticks"]] * 4
    for a, b in zip(tstate.tree_leaves(got), tstate.tree_leaves(want)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
