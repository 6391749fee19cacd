"""PyTorch port, the study's host copy (``netsim/state.py``
``to_host_batch``, ``HostBlocks``, ``host_offsets``): a finished lane batch
copied into one host block, a slice a leaf.  On the CPU, with an unpinned
block standing in for the page-locked one: every leaf bit-equal to
``to_numpy``'s (dtype, shape, tree), at an aligned offset and writable; a
block is lent again only once every view of it is gone; a CPU study keeps
``to_numpy``, its states and the ``study.host_copy`` span's bytes.  The
card's tests (``gpu``) hold a study's states to views of one page-locked
block, the second study of a grid to a reused block, and a kept result to
its values across a later study."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.trace_guard import recording, trace_guard  # noqa: E402
from repro_torch.netsim import api, shard, state  # noqa: E402

POINTS = ({}, {"start_cwnd_mult": 0.5})
SEEDS = (0, 1)
NEW, REUSED = "study.host_copy.pinned_new", "study.host_copy.pinned_reused"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _study(device="cpu", seeds=SEEDS):
    return api.study("tiny_3t", points=POINTS, seeds=seeds, device=device)


def _final_batch(plan):
    """The finished ``[L]`` batch on the plan's device, as a study's copy
    receives it."""
    return shard.run_lanes(plan.sim, plan.consts_b, plan.axes, plan.init(),
                           plan._max_ticks(None))


@pytest.fixture(scope="module")
def batch():
    return _final_batch(_study())


def _assert_trees_equal(a, b):
    """Same NamedTuple structure, and every leaf of the same dtype and shape
    and equal in every bit."""
    assert type(a) is type(b)
    if hasattr(a, "_fields"):
        for x, y in zip(a, b):
            _assert_trees_equal(x, y)
        return
    assert isinstance(a, (np.ndarray, np.generic)) and type(a) is type(b)
    assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _ptr(x: np.ndarray) -> int:
    return x.__array_interface__["data"][0]


def test_leaves_are_bit_equal_to_to_numpy(batch):
    out = state.to_host_batch(batch, state.HostBlocks(pin=False))
    _assert_trees_equal(out, state.to_numpy(batch))
    leaves = state.tree_leaves(out)
    kinds = {x.dtype for x in leaves}
    assert {np.dtype(np.bool_), np.dtype(np.int32), np.dtype(np.float32)} <= kinds
    assert out.now.shape == (len(POINTS) * len(SEEDS),)      # a per-lane scalar
    assert int(out.now.min()) > 0 and bool(out.done.all())   # a finished batch


def test_non_contiguous_leaf(batch):
    x = batch.q_fields
    odd = batch._replace(q_fields=x.transpose(2, 3).contiguous().transpose(2, 3))
    assert not odd.q_fields.is_contiguous()
    _assert_trees_equal(state.to_host_batch(odd, state.HostBlocks(pin=False)),
                        state.to_numpy(batch))


def test_offsets_are_aligned_and_apart(batch):
    leaves = state.tree_leaves(batch)
    offs, total = state.host_offsets(leaves)
    out = state.tree_leaves(state.to_host_batch(batch, state.HostBlocks(pin=False)))
    root = out[0].base
    assert all(x.base is root for x in out) and root.nbytes == total
    for x, h, o in zip(leaves, out, offs):
        assert o % state.HOST_ALIGN == 0 and _ptr(h) - _ptr(root) == o
        assert h.nbytes == x.nbytes
    ends = [o + x.nbytes for x, o in zip(leaves, offs)]
    assert all(e <= o for e, o in zip(ends, offs[1:])) and ends[-1] <= total


def test_leaves_are_writable_alone(batch):
    out = state.to_host_batch(batch, state.HostBlocks(pin=False))
    want = state.to_numpy(batch)
    for leaf in state.tree_leaves(out):
        assert leaf.flags.writeable
    out.fct[...] = -7
    out.done[...] = False
    assert (out.fct == -7).all() and not out.done.any()
    for name in ("now", "goodput", "unacked"):
        assert getattr(out, name).tobytes() == getattr(want, name).tobytes()


def test_block_is_lent_again_only_when_every_view_is_gone(batch):
    blocks = state.HostBlocks(pin=False)
    with trace_guard(NEW) as new, trace_guard(REUSED) as reused:
        first = state.to_host_batch(batch, blocks)
        root = first.now.base
        second = state.to_host_batch(batch, blocks)       # first still held
        assert (new.count, reused.count) == (2, 0) and second.now.base is not root
        lane = state.lane(first, 1)                       # a view keeps it lent
        del first
        third = state.to_host_batch(batch, blocks)
        assert (new.count, reused.count) == (3, 0) and third.now.base is not root
        _assert_trees_equal(lane, state.lane(state.to_numpy(batch), 1))
        del lane, root
        fourth = state.to_host_batch(batch, blocks)
        assert (new.count, reused.count) == (3, 1)
    assert blocks.held_bytes() == 3 * state.host_offsets(state.tree_leaves(batch))[1]
    _assert_trees_equal(second, state.to_numpy(batch))
    _assert_trees_equal(fourth, third)


def test_other_size_drops_free_blocks(batch):
    blocks = state.HostBlocks(pin=False)
    half = state.tree_map(lambda x: x[:2], batch)
    total = state.host_offsets(state.tree_leaves(batch))[1]
    out = state.to_host_batch(batch, blocks)
    del out
    kept = state.to_host_batch(half, blocks)
    assert blocks.held_bytes() == state.host_offsets(state.tree_leaves(half))[1] < total
    _assert_trees_equal(kept, state.to_numpy(half))


def test_cpu_study_keeps_to_numpy(batch):
    """A CPU study copies with ``to_numpy`` (no block lent): its states
    equal the batch's, and the span still counts the leaves' bytes."""
    with trace_guard(NEW, expect=0), trace_guard(REUSED, expect=0):
        with recording() as rec:
            res = _study().run()
    _assert_trees_equal(res.states, state.to_numpy(batch))
    copy = [r for r in rec.rows() if r[0] == "study.host_copy"]
    assert len(copy) == 1
    assert copy[0][5] == {"bytes": sum(x.nbytes for x in state.tree_leaves(res.states))}
    assert all(x.base is None or not isinstance(x.base, np.ndarray)
               for x in state.tree_leaves(res.states))


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_study_states_view_one_pinned_block(monkeypatch):
    _need_card()
    seen = {}
    real = state.to_host_batch

    def spy(tree, *args, **kw):
        seen["batch"] = state.to_numpy(tree)
        return real(tree, *args, **kw)

    monkeypatch.setattr(state, "to_host_batch", spy)
    res = _study("cuda").run()
    leaves = state.tree_leaves(res.states)
    root = leaves[0].base
    assert all(x.base is root for x in leaves)
    assert isinstance(root.base, torch.Tensor) and root.base.is_pinned()
    _assert_trees_equal(res.states, seen["batch"])
    assert all(x.flags.writeable for x in leaves)


@pytest.mark.gpu
def test_second_study_reuses_the_block():
    _need_card()
    plan = _study("cuda")
    with trace_guard(NEW) as new, trace_guard(REUSED) as reused:
        res = plan.run()
    assert new.count + reused.count == 1
    root = res.states.now.base
    want = [x.copy() for x in state.tree_leaves(res.states)]
    ptr = _ptr(root)
    del res, root
    with trace_guard(NEW, expect=0), trace_guard(REUSED, expect=1):
        again = _study("cuda").run()
    assert _ptr(again.states.now.base) == ptr
    for x, y in zip(state.tree_leaves(again.states), want):
        assert x.tobytes() == y.tobytes()


@pytest.mark.gpu
def test_kept_result_survives_a_later_study():
    _need_card()
    kept = _study("cuda").run()
    want = [x.copy() for x in state.tree_leaves(kept.states)]
    rows = kept.rows()
    later = _study("cuda", seeds=(5, 6)).run()
    assert later.states.now.base is not kept.states.now.base
    assert _ptr(later.states.now.base) != _ptr(kept.states.now.base)
    assert any(x.tobytes() != y.tobytes() for x, y in
               zip(state.tree_leaves(later.states), want))
    for x, y in zip(state.tree_leaves(kept.states), want):
        assert x.tobytes() == y.tobytes()
    assert kept.rows() == rows
