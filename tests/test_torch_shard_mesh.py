"""PyTorch port, a lane batch spread over a mesh of devices
(``repro_torch.netsim.shard.run_lanes`` with ``mesh=``) on the CPU: the
counterparts of ``tests/test_shard.py``'s multi-device tests.  The CPU is
one device to torch, so its mesh repeats it (``["cpu"] * k``), as the
reference's tests force four host devices; each shard still runs its own
lane loop on a thread of its own.  Every run over a mesh is bit-equal,
leaf for leaf and ``now`` included, to the one-device batch (which
``test_torch_lanes.py`` holds to each lane's standalone run): meshes of
2, 3 and 4 devices (4 pads the 6 lanes to 8), ``Study.run`` with
``cache=`` and ``chunk_lanes=``, ``Sim.run_batch``, an eqds study, and a
grid whose shards finish far apart.  Also the lane counts, the one lane
loop a run counts, the meshes that raise, and each shard's operands
through every fused kernel wrapper's checks.  The JAX package's own
sharded run is held to the port's in ``test_torch_shard_jax.py``."""

import threading

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import trace_guard  # noqa: E402
from repro_torch.netsim import api, engine, shard, state  # noqa: E402
from test_torch_engine import one_torch_thread  # noqa: E402,F401 (autouse)

CPU = "cpu"
POINTS = ({}, {"start_cwnd_mult": 0.5})
SEEDS = (0, 1, 2)


def _study(name="tiny_3t", points=POINTS, seeds=SEEDS, **ov):
    return api.study(name, points=points, seeds=seeds, device=CPU, **ov)


def _assert_state_equal(a, b):
    la, lb = state.tree_leaves(state.to_numpy(a)), state.tree_leaves(state.to_numpy(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.fixture(scope="module")
def plan():
    st = _study()
    return st, st.run_states(), dict(st.sim.stats["lanes"])


@pytest.mark.parametrize("k", [2, 3, 4])
def test_mesh_bit_equal_to_one_device(plan, k):
    """6 lanes over k devices: 3 and 2 lanes a shard, or 8 lanes (two pad
    lanes) of 2; every leaf of every lane equal to the one-device batch,
    the lane counts too, the batch back on the sim's device as ``[6]``."""
    st, ref, counts = plan
    mt = st._max_ticks(None)
    out = shard.run_lanes(st.sim, st.consts_b, st.axes, st.init(), mt,
                          mesh=shard.lane_mesh([CPU] * k))
    assert int(out.now.shape[0]) == st.n_lanes and out.now.device == st.device
    _assert_state_equal(out, ref)
    lanes = st.sim.stats["lanes"]
    for key in ("steps", "leaps", "ticks"):
        assert lanes[key] == counts[key]
    per = -(-st.n_lanes // k)
    assert len(lanes["shard_ticks"]) == k
    assert lanes["shard_ticks"] == [max(counts["steps"][i * per:(i + 1) * per], default=0)
                                    for i in range(k)]
    assert lanes["batch_ticks"] == sum(lanes["shard_ticks"])
    assert st.sim.stats["steps"] == counts["steps"][0]


def test_study_run_rows_with_cache_and_chunks(plan, tmp_path):
    """``Study.run(mesh=)`` rows equal the one-device rows; with a cache
    and two lanes a chunk too, each chunk spread over the mesh, and a
    second run served from the cache alone."""
    st, ref, _ = plan
    want = st.run()
    mesh = [CPU] * 2
    got = st.run(mesh=mesh)
    strip = lambda rows: [{k: v for k, v in r.items() if k != "wall_s"} for r in rows]  # noqa: E731
    assert strip(got.rows()) == strip(want.rows())
    _assert_state_equal(got.states, ref)
    chunked = st.run(mesh=mesh, cache=tmp_path / "c", chunk_lanes=2)
    assert (chunked.cache_hits, chunked.cache_misses) == (0, st.n_lanes)
    assert strip(chunked.rows()) == strip(want.rows())
    _assert_state_equal(chunked.states, ref)
    again = st.run(mesh=[CPU] * 3, cache=tmp_path / "c", chunk_lanes=2)
    assert (again.cache_hits, again.cache_misses) == (st.n_lanes, 0)
    _assert_state_equal(again.states, ref)
    _assert_state_equal(st.run_states(mesh=mesh), ref)


def test_run_batch_over_four(plan):
    """``Sim.run_batch(range(5), mesh=[cpu] * 4)``: 5 seeds padded to 8."""
    sim = plan[0].sim
    mt = plan[0]._max_ticks(None)
    want = sim.run_batch(range(5), mt)
    got = sim.run_batch(range(5), mt, mesh=[CPU] * 4)
    _assert_state_equal(got, want)
    assert sim.stats["lanes"]["shard_ticks"][-1] == 0      # its lanes are pads


def test_eqds_over_two():
    """EQDS's grants (all of a shard's receiver rows in one ``rr_pick``)."""
    st = _study(points=({}, {"credit_window_mult": 1.5}), seeds=(0, 1), algo="eqds")
    ref = st.run_states()
    _assert_state_equal(st.run_states(mesh=[CPU] * 2), ref)


def test_shards_finish_apart():
    """tiny_incast3 under three points: a shard a point, the third's window
    so small that its lanes leap to the budget at once.  Each shard stops
    on its own (23, 45 and 0 batched ticks), every lane still the
    one-device batch's."""
    st = _study("tiny_incast3", points=({}, {"start_cwnd_mult": 0.1},
                                         {"start_cwnd_mult": 0.01}), seeds=(0, 1))
    ref = st.run_states()
    counts = dict(st.sim.stats["lanes"])
    got = st.run_states(mesh=[CPU] * 3)
    _assert_state_equal(got, ref)
    lanes = st.sim.stats["lanes"]
    assert lanes["shard_ticks"] == [max(counts["steps"][2 * i:2 * i + 2]) for i in range(3)]
    assert lanes["shard_ticks"][2] == 0 and lanes["shard_ticks"][0] < lanes["shard_ticks"][1]
    assert lanes["leaps"][4:] == [1, 1] and lanes["ticks"] == counts["ticks"]


def test_one_lane_loop_a_sharded_run(plan):
    """A run over a mesh counts one lane loop, as the reference's shard_map
    traces its body once."""
    st = plan[0]
    with trace_guard("shard.lane_loop", expect=1):
        res = st.run(mesh=[CPU] * 3)
    assert len(res) == st.n_lanes


@pytest.mark.parametrize("mesh,err", [(object(), TypeError), ([], ValueError),
                                      ("cpu", TypeError), ([CPU, 3.5], TypeError),
                                      ([CPU, "meta"], ValueError)],
                         ids=["object", "empty", "string", "not-a-device", "other-type"])
def test_bad_mesh_raises(plan, mesh, err):
    """A mesh that is not a list of devices of the sim's type raises,
    through every entry point; it never runs some other way."""
    st = plan[0]
    for call in (lambda: st.run(mesh=mesh), lambda: st.run_states(mesh=mesh),
                 lambda: st.sim.run_batch([0], 10, mesh=mesh)):
        with pytest.raises(err):
            call()


def test_earlier_designs_refuse_a_mesh():
    """An earlier design's one-lane backend runs no mesh, one lane or more."""
    sim = api.scenarios.scenario("tiny_3t", departures_backend="plain").build(device=CPU)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sim.run_batch([0], 40, mesh=[CPU] * 2)
    assert sim.run_batch([0], 40, mesh=[CPU]).now.tolist() == [sim.run(40).now.item()]


def test_a_shard_that_raises_makes_the_run_raise(plan, monkeypatch):
    """Nothing is caught: a shard's fault is the run's."""
    st = plan[0]
    real = shard._loop

    def loop(sim, consts_b, axes, max_ticks, host=None):
        run = real(sim, consts_b, axes, max_ticks, host)

        def faulty(states):
            if int(states.salt[0]) == 2:
                raise RuntimeError("shard fault")
            return run(states)
        return faulty
    monkeypatch.setattr(shard, "_loop", loop)
    with pytest.raises(RuntimeError, match="shard fault"):
        st.run_states(mesh=[CPU] * 3)


def test_shard_operands_pass_every_wrapper_check(plan, monkeypatch):
    """Route each shard's kernel calls through the CUDA wrappers on the CPU
    (from the shards' own threads): every operand check must pass, each
    shard's state a block of the padded batch, so the only refusal left is
    the one that says the tensors are not on a card; then the plain
    version runs, and the result is still the one-device batch's."""
    from repro_torch.kernels import build
    from repro_torch.kernels.arrivals import kernel as AK, ref as AR
    from repro_torch.kernels.control import kernel as XK, ref as XR
    from repro_torch.kernels.departures import kernel as PK, ref as PR
    from repro_torch.kernels.sends import kernel as SK, ref as SR
    st, ref, _ = plan
    calls, lock = {}, threading.Lock()
    for mod, name, plain in ((PK, "departures", PR.departures_lanes_ref),
                             (AK, "arrivals", AR.arrivals_lanes_ref),
                             (XK, "control", XR.control_lanes_ref),
                             (SK, "sends", SR.sends_lanes_ref)):
        def wrapper(*a, orig=getattr(mod, name), name=name, plain=plain, **kw):
            with pytest.raises(ValueError, match="needs CUDA tensors"):
                orig(*a, **kw)
            with lock:
                calls[name] = calls.get(name, 0) + 1
            return plain(*a, **kw)
        monkeypatch.setattr(mod, name, wrapper)
    monkeypatch.setattr(build, "use_kernel", lambda backend, x: backend == "kernel")
    _assert_state_equal(st.run_states(mesh=[CPU] * 4), ref)
    ticks = st.sim.stats["lanes"]["batch_ticks"]
    assert calls == {n: ticks for n in ("departures", "arrivals", "control", "sends")}


def test_launch_counts_exact_under_threads():
    """``build.count``, the wrappers' counter update, loses no update when
    more threads than cores add at once with a short switch interval."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import build

    def fn():
        pass
    fn.launches = fn.launches_x = 0
    n_threads, each = 32, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(n_threads) as pool:
            futures = [pool.submit(lambda: [build.count(fn, launches=1, launches_x=2)
                                            for _ in range(each)])
                       for _ in range(n_threads)]
        for f in futures:
            f.result(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert (fn.launches, fn.launches_x) == (n_threads * each, 2 * n_threads * each)


def test_lane_mesh_names_the_devices():
    """``lane_mesh(devices)`` is those devices; with none, every card, and
    without a card it raises instead of returning the CPU."""
    assert shard.lane_mesh([CPU] * 2) == [torch.device(CPU)] * 2
    if torch.cuda.is_available():
        assert len(shard.lane_mesh()) == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="is_available"):
            shard.lane_mesh()
    assert not hasattr(engine, "MESH_TODO")
