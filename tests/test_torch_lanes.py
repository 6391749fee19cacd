"""PyTorch port, a study's lanes as one batch (``netsim/shard.py``'s lane
loop) on the CPU: every lane of a batched study equals the standalone
``Sim.run`` of its (point, seed) in every state leaf, bitwise, ``now``
included — SMaRTT with REPS on tiny_incast3, incast8_16n and
perm_128n_3t and the Swift baseline's CC in PyTorch, under grids that sweep the initial window,
the RED thresholds, the RTO, the entropy count and a CC key (so every
fused phase reads a constant of its own a lane) and make lanes finish at
different ticks and leap by different distances.  Also the batched plain
version of each fused phase against the single-lane one, lane for lane,
on ``kernels/cases.py``'s lane batches (``LANES_CASES``: lanes at their
own ticks, one not live), and a batch's operands through every CUDA
wrapper's checks.  The eqds, bbr, fault, dependency and JAX cases are in
``test_torch_lanes_b.py``."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import cases  # noqa: E402
from repro_torch.kernels.arrivals import ref as AR  # noqa: E402
from repro_torch.kernels.control import ref as XR  # noqa: E402
from repro_torch.kernels.departures import ref as PR  # noqa: E402
from repro_torch.kernels.sends import ref as SR  # noqa: E402
from repro_torch.netsim import api, engine, state  # noqa: E402
from test_torch_engine import one_torch_thread  # noqa: E402,F401 (autouse)


def assert_lanes_equal_standalone(name, points, seeds, max_ticks=None, **overrides):
    """Run a study as one lane batch and each of its lanes standalone; every
    state leaf bitwise.  Returns the lane loop's per-lane counts."""
    plan = api.study(name, points=points, seeds=seeds, device="cpu", **overrides)
    mt = plan._max_ticks(max_ticks)
    got = plan.run_states(mt)
    counts = dict(plan.sim.stats["lanes"])
    sc = plan.scenario
    for lane in range(plan.n_lanes):
        pt, seed = plan.lane_point_seed(lane)
        sim = engine.build(api.apply_point(sc.cfg, dict(pt)), sc.wl, device="cpu")
        alone = state.to_numpy(sim.run(mt, seed=seed))
        assert counts["steps"][lane] == sim.stats["steps"], (lane, pt, seed)
        assert counts["leaps"][lane] == sim.stats["leaps"], (lane, pt, seed)
        mine = state.lane(got, lane)
        for (n, a), (_, b) in zip(_named(alone), _named(mine)):
            assert a.dtype == b.dtype and a.shape == b.shape, n
            assert a.tobytes() == b.tobytes(), (name, lane, dict(pt), seed, n)
    return counts


def _named(tree, prefix=""):
    if hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _named(v, f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


SWEEP = ({}, {"start_cwnd_mult": 0.5, "kmin_frac": 0.3},
         {"rto_mult": 5.0, "num_entropies": 16}, {"fd": 0.6, "kmin_frac": 0.1})


def test_smartt_reps_tiny_incast3():
    counts = assert_lanes_equal_standalone("tiny_incast3", SWEEP, (0, 5))
    assert counts["batch_ticks"] == max(counts["steps"])


def test_smartt_reps_lanes_finish_and_leap_apart():
    """incast8_16n under the sweep: lanes finish at different ticks and
    leap at different supersteps, each still its standalone run."""
    counts = assert_lanes_equal_standalone("incast8_16n", SWEEP[1:], (0, 5))
    assert len(set(counts["ticks"])) > 1
    assert len(set(counts["leaps"])) > 1
    assert counts["batch_ticks"] == max(counts["steps"])


def test_smartt_reps_perm_128n_3t():
    points = ({}, {"start_cwnd_mult": 1.0, "kmin_frac": 0.3, "fd": 0.6},
              {"num_entropies": 64, "rto_mult": 4.0})
    counts = assert_lanes_equal_standalone("perm_128n_3t", points, (0,))
    assert len(set(counts["ticks"])) > 1


def test_swift_baseline_sparse():
    """The baselines' CC runs in PyTorch after the fused control launch,
    written only where a lane is live; tiny_sparse leaps."""
    points = ({}, {"sw_beta": 0.5, "kmin_frac": 0.3}, {"start_cwnd_mult": 0.5,
                                                        "rto_mult": 4.0})
    counts = assert_lanes_equal_standalone("tiny_sparse", points, (2,), algo="swift")
    assert all(counts["leaps"])


# ------------------------------------------ the batched plain versions


def _run_one(kind, lc, o):
    """The single-lane plain version of ``kind`` on each live lane's view."""
    for i, go in enumerate(lc["tick"].live_h):
        if not go:
            continue
        view = state.tree_map(lambda x: None if x is None else x[i], o)
        args = lc["one"][i]
        if kind == "departures":
            PR.departures_ref(*args, view)
        elif kind == "arrivals":
            AR.arrivals_ref(*args, view)
        elif kind == "control":
            XR.control_ref(*args, view)
        else:
            SR.sends_ref(*args, view)


def _run_lanes(kind, lc, o):
    k, fl = lc["tick"], lc["flags"]
    if kind == "departures":
        return PR.departures_lanes_ref(k, lc["lat"], fl, o)
    if kind == "arrivals":
        return AR.arrivals_lanes_ref(k, lc["trim_delay"], fl, o, lc["gbin"])
    if kind == "control":
        return XR.control_lanes_ref(k, fl, o)
    return SR.sends_lanes_ref(k, lc["lat_send"], fl, o)


@pytest.mark.parametrize("kind,shape,seed,flags", cases.LANES_CASES,
                         ids=[f"{c[0]}-{c[2]}" for c in cases.LANES_CASES])
def test_batched_plain_equals_single_lane(kind, shape, seed, flags):
    """Each fused phase's batched plain version, lane for lane, against
    today's single-lane one at the lane's own tick; the lane that is not
    live is left as it was."""
    case = cases.lanes_case(kind, shape, seed, **flags)
    a = cases.lanes_operands(case, "cpu")
    b = cases.lanes_operands(case, "cpu")
    before = state.tree_map(lambda x: None if x is None else x.clone(), b["o"])
    assert len(set(a["tick"].now_h)) == len(a["tick"].now_h)   # lanes at their own ticks
    ev = _run_lanes(kind, a, a["o"])
    _run_one(kind, b, b["o"])
    idle = a["tick"].live_h.index(False)
    for x, y, z in zip(state.tree_leaves(a["o"]), state.tree_leaves(b["o"]),
                       state.tree_leaves(before)):
        if x is None:
            continue
        assert torch.equal(x, y)
        assert torch.equal(x[idle], z[idle])
    if kind == "control":
        one = [XR.control_ref(*b["one"][i], state.tree_map(
            lambda x: None if x is None else x[i], cases.lanes_operands(case, "cpu")["o"]))
            for i in range(len(case["cases"]))]
        for i, go in enumerate(a["tick"].live_h):
            for f in ev._fields:
                want = getattr(one[i], f) if go else torch.zeros_like(getattr(one[i], f))
                assert torch.equal(getattr(ev, f)[i], want), (i, f)


# ------------------------------------- a batch through the wrappers' checks


def test_lane_operands_pass_every_wrapper_check(monkeypatch):
    """A three-lane study whose points sweep a constant of every fused
    phase, routed through the CUDA wrappers on the CPU: every operand
    check of the ``[L, ...]`` batch passes (lane strides, shared constants
    as expanded views), so the only refusal left is the one that says the
    tensors are not on a card; then the batched plain version runs.  One
    launch of each a batched tick."""
    from repro_torch.kernels import build
    from repro_torch.kernels.arrivals import kernel as AK
    from repro_torch.kernels.control import kernel as XK
    from repro_torch.kernels.departures import kernel as PK
    from repro_torch.kernels.sends import kernel as SK

    calls = {}

    def rehearse(mod, fn_name, plain):
        orig = getattr(mod, fn_name)

        def wrapper(*args, **kw):
            with pytest.raises(ValueError, match="needs CUDA tensors"):
                orig(*args, **kw)
            calls[fn_name] = calls.get(fn_name, 0) + 1
            return plain(*args, **kw)
        monkeypatch.setattr(mod, fn_name, wrapper)

    rehearse(XK, "control", XR.control_lanes_ref)
    rehearse(AK, "arrivals", AR.arrivals_lanes_ref)
    rehearse(SK, "sends", SR.sends_lanes_ref)
    rehearse(PK, "departures", PR.departures_lanes_ref)
    monkeypatch.setattr(build, "use_kernel", lambda backend, x: backend == "kernel")
    plan = api.study("perm_128n_3t", points=SWEEP[1:], seeds=(0,), device="cpu")
    plan.run_states(40)
    batch = plan.sim.stats["lanes"]["batch_ticks"]
    assert set(calls) == {"departures", "control", "arrivals", "sends"} and \
        all(v == batch == 40 for v in calls.values()), calls
