"""PyTorch port, a study's lanes as one batch on the CPU, continued from
``test_torch_lanes.py``: every lane equal to its standalone ``Sim.run``
bitwise, ``now`` included, under EQDS's grants (all lanes' receiver rows
in one ``rr_pick``), BBR's pacing (leaping off), corefail_128n_3t's fault
schedule with the tick budget cut short (``fault_start`` swept, so each
lane has its own schedule), and alltoall16_w4's windows (several flows a
sender).  Then the batched study's rows and final states against the JAX
package's own vmapped study: integers exact, f32 within the recorded
16-ULP run budget."""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.netsim import api as japi  # noqa: E402
from repro_torch.netsim import api, state  # noqa: E402
from test_torch_engine import RUN_ULP_BUDGET, _ulp, one_torch_thread  # noqa: E402,F401
from test_torch_lanes import assert_lanes_equal_standalone  # noqa: E402


def test_eqds_grants():
    points = ({}, {"credit_window_mult": 1.5}, {"start_cwnd_mult": 0.5, "kmin_frac": 0.3})
    counts = assert_lanes_equal_standalone("tiny_incast3", points, (0, 1), algo="eqds")
    assert counts["batch_ticks"] == max(counts["steps"])


def test_bbr_paced_without_leaps():
    points = ({}, {"start_cwnd_mult": 0.5}, {"rto_mult": 4.0, "kmin_frac": 0.3})
    counts = assert_lanes_equal_standalone("tiny_3t", points, (0, 1), algo="bbr")
    assert not any(counts["leaps"])


def test_corefail_fault_schedule_cut_short():
    points = ({"rto_mult": 4.0, "num_entropies": 64}, {"fault_start": 100})
    counts = assert_lanes_equal_standalone("corefail_128n_3t", points, (0,), max_ticks=640)
    assert counts["ticks"] == [640, 640]          # both past their failure


def test_alltoall_windows_and_several_flows_a_sender():
    points = ({}, {"start_cwnd_mult": 0.75, "kmin_frac": 0.3})
    assert_lanes_equal_standalone("alltoall16_w4", points, (0, 1))


@pytest.mark.parametrize("name,points,algo", [
    ("tiny_incast3", ({}, {"start_cwnd_mult": 0.5, "kmin_frac": 0.3},
                      {"rto_mult": 5.0, "num_entropies": 16, "fd": 0.6}), "smartt"),
    ("tiny_3t", ({}, {"credit_window_mult": 1.5}), "eqds"),
], ids=["tiny_incast3", "tiny_3t-eqds"])
def test_study_matches_reference_vmapped_study(name, points, algo):
    """The batched study's rows equal the JAX package's vmapped study's on
    every key but ``wall_s``; the final states leaf for leaf: integers
    exact, f32 within RUN_ULP_BUDGET."""
    want = japi.study(name, points=points, seeds=(0, 3), algo=algo).run()
    got = api.study(name, points=points, seeds=(0, 3), algo=algo, device="cpu").run()
    strip = lambda rows: [{k: v for k, v in r.items() if k != "wall_s"} for r in rows]  # noqa: E731
    assert strip(got.rows()) == strip(want.rows())
    la, lb = state.tree_leaves(got.states), _leaves(want.states)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        b = np.asarray(b)
        assert a.shape == b.shape
        if a.dtype == np.float32:
            assert _ulp(a, b) <= RUN_ULP_BUDGET
        else:
            np.testing.assert_array_equal(a, b.astype(a.dtype))


def _leaves(tree):
    if hasattr(tree, "_fields"):
        return [x for sub in tree for x in _leaves(sub)]
    return [tree]
