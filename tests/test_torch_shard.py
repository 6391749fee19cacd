"""PyTorch port, the lane loop (``repro_torch.netsim.shard``) on the CPU:
the counterparts of ``tests/test_shard.py`` on one device.  Padding a lane
batch adds frozen lanes (copies of the last lane with every flow done)
that the lane gate leaves bitwise as they were, and is a no-op when the
batch already divides; ``run_lanes`` with no mesh and with a one-device
mesh gives the same states; a mesh over more devices raises (lanes over
several cards are not ported), it never runs on one device instead."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.netsim import api, shard, state  # noqa: E402
from test_torch_engine import one_torch_thread  # noqa: E402,F401 (autouse)

POINTS = ({}, {"start_cwnd_mult": 0.5})
SEEDS = (0, 1, 2)


def _study():
    return api.study("tiny_3t", points=POINTS, seeds=SEEDS, device="cpu")


def _assert_state_equal(a, b):
    la, lb = state.tree_leaves(state.to_numpy(a)), state.tree_leaves(state.to_numpy(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def test_pad_lanes_shapes_and_inertness():
    """Pad lanes copy the last lane with every flow done: every leaf grows
    to the multiple, the swept constants too, the shared ones stay; run
    through the lane loop, the real lanes equal the unpadded run and the
    pad lanes end exactly as they began."""
    st = _study()
    mt = st._max_ticks(None)
    ref = st.run_states(mt)
    states, consts_p, n_pad = shard.pad_lanes(st.init(), st.consts_b, st.axes, 4)
    assert n_pad == 2 and int(states.now.shape[0]) == 8
    for x in state.tree_leaves(states):
        assert x.shape[0] == 8
    for x, a in zip(state.tree_leaves(consts_p), shard.axes_leaves(st.axes)):
        assert a is None or x.shape[0] == 8
    assert bool(states.done[6:].all()) and not bool(states.done[:6].all())
    before = state.to_numpy(states)
    out = shard.run_lanes(st.sim, consts_p, st.axes, states, mt)
    got = state.to_numpy(out)
    _assert_state_equal(state.tree_map(lambda x: x[:6], got), ref)
    _assert_state_equal(state.tree_map(lambda x: x[6:], got),
                        state.tree_map(lambda x: x[6:], before))
    assert st.sim.stats["lanes"]["steps"][6:] == [0, 0]


def test_pad_lanes_noop_when_divisible():
    st = _study()
    states = st.init()
    out, consts_p, n_pad = shard.pad_lanes(states, st.consts_b, st.axes, 3)
    assert n_pad == 0 and out is states and consts_p is st.consts_b


def test_run_lanes_one_device_mesh_matches_no_mesh():
    """A mesh of one device is the single-device path: the same states."""
    st = _study()
    mt = st._max_ticks(None)
    plain = state.to_numpy(shard.run_lanes(st.sim, st.consts_b, st.axes, st.init(), mt))
    mesh = shard.lane_mesh(["cpu"])
    assert mesh == [torch.device("cpu")]
    meshed = state.to_numpy(shard.run_lanes(st.sim, st.consts_b, st.axes, st.init(), mt,
                                            mesh=mesh))
    _assert_state_equal(plain, meshed)
    _assert_state_equal(st.run_states(mesh=mesh), plain)


def test_axes_leaves_align_with_the_constants():
    st = _study()
    leaves = state.tree_leaves(st.consts_b)
    axes = shard.axes_leaves(st.axes)
    assert len(axes) == len(leaves) and set(axes) == {None, 0}
    swept = [x for x, a in zip(leaves, axes) if a == 0]
    assert swept and all(x.shape[0] == st.n_lanes for x in swept)
    assert st.axes.start_cwnd == 0 and st.axes.kmin is None


@pytest.mark.parametrize("key,value", [("departures_backend", "plain"),
                                       ("fabric_backend", "split"),
                                       ("sender_backend", "split"),
                                       ("transport_backend", "split")])
def test_earlier_designs_refuse_a_lane_batch(key, value):
    """The earlier designs' backends run one lane: a study, or a seed batch
    of more than one, that names one raises at plan time and names the
    roadmap, never runs some other way; one lane still runs."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        api.study("tiny_3t", seeds=(0, 1), device="cpu", **{key: value})
    sim = api.scenarios.scenario("tiny_3t", **{key: value}).build(device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sim.run_batch([0, 1], 40)
    assert sim.run_batch([0], 40).now.tolist() == [sim.run(40).now.item()]


def test_lane_operand_takes_an_empty_block():
    """A lane-batched operand whose per-lane block is empty (a sends case
    with no dependencies: ``dep_par [L, F, 0]``) passes the wrappers'
    check with lane stride 0, whatever strides PyTorch gives a zero-size
    tensor; a non-empty block still needs its own row a lane."""
    from repro_torch.kernels import lanes
    x = torch.zeros((4, 0, 600), dtype=torch.int32)
    assert x.stride(0) != 0
    _, stride = lanes.operand(x, "dep_par", torch.int32, (0, 600), x.device, 4, state=True)
    assert stride == 0
    y = torch.zeros((4, 3, 600), dtype=torch.int32)[:, :2]
    with pytest.raises(ValueError, match="lane stride"):
        lanes.operand(y, "dep_par", torch.int32, (2, 600), y.device, 4, state=True)
