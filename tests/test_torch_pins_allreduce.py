"""PyTorch port, allreduce_ring_128n_3t: a bucket ring allreduce over all
128 nodes of the 128-node three-tier tree, 32 512 flows chained by the
dependency gate (each step waits for the chunk its ring predecessor
forwards).  The reference's whole run is pinned here for ``chip_smoke.py``
(its summary, its ``RunResult`` row and its collective completion time,
CCT = 3893 ticks, by the reference's own ``RunResult``); the port runs
the first ticks on the CPU against the reference's state at the same
tick (a whole CPU run of the port takes minutes; the card runs it
whole)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.netsim import api as japi  # noqa: E402
from repro.netsim import metrics as jmetrics  # noqa: E402
from repro.netsim import scenarios as jscen  # noqa: E402
from repro_torch.netsim import scenarios as tscen  # noqa: E402
from repro_torch.netsim import state as tstate  # noqa: E402
from test_torch_engine import RUN_ULP_BUDGET, _leaves, _ulp  # noqa: E402
from test_torch_engine import one_torch_thread  # noqa: E402,F401 (autouse)
from test_torch_pins_corefail import assert_pinned  # noqa: E402

NAME = "allreduce_ring_128n_3t"
PREFIX = 150


def test_allreduce_ring_reference_is_pinned():
    sc = jscen.scenario(NAME)
    sim = sc.build()
    st = sim.run(sc.max_ticks)
    summ = jmetrics.summarize(sim, st)
    rr = japi.RunResult.from_state(sim, st, scenario=NAME, max_ticks=sc.max_ticks)
    summ["cct"] = rr.cct
    summ["row"] = rr.row()
    assert summ["all_done"] and rr.cct == summ["fct_max"]
    assert_pinned(NAME, summ)


def test_allreduce_ring_prefix_matches_reference():
    sc = jscen.scenario(NAME)
    jsim = sc.build()
    jst = jax.tree.map(np.asarray, jsim.run(PREFIX))
    tsim = tscen.scenario(NAME).build(device="cpu")
    assert tsim.dims.NF == 32512 and tsim.dims.D == 1 and tsim.dims.FMAX == 254
    tst = tstate.to_numpy(tsim.run(PREFIX))
    for (n, a), (_, b) in zip(_leaves(jst), _leaves(tst)):
        assert a.dtype == b.dtype and a.shape == b.shape, n
        if a.dtype == np.float32:
            assert _ulp(a, b) <= RUN_ULP_BUDGET, n
        else:
            np.testing.assert_array_equal(a, b, err_msg=n)
    assert int(tst.m.delivered_pkts) > 0 and tst.done.sum() > 0
