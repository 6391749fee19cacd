"""PyTorch port, dependency-driven collectives (DESIGN.md Sec. 11) against
the JAX reference on the CPU: the generators' workload tables byte for
byte (every registered collective scenario, and the generators at other
sizes, spread and tree branchings), and whole runs of the small
collective scenarios with the dependency gate releasing each flow as its
parents' bytes land.  allreduce_ring_128n_3t (32 512 flows) is pinned in
``test_torch_pins_allreduce.py``."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.netsim import collectives as jcoll  # noqa: E402
from repro.netsim import scenarios as jscen  # noqa: E402
from repro_torch.netsim import collectives as tcoll  # noqa: E402
from repro_torch.netsim import scenarios as tscen  # noqa: E402
from test_torch_engine import assert_run_parity  # noqa: E402
from test_torch_engine import one_torch_thread  # noqa: E402,F401 (autouse)

COLLECTIVE_SCENARIOS = ("tiny_allreduce_ring", "tiny_allgather", "tiny_pipeline",
                        "allreduce_ring_128n_3t", "allreduce_tree_128n_3t",
                        "allgather_64n_3t", "pipeline_32n")


def _assert_tables_equal(a, b, what):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, (what, f.name)
            assert x.tobytes() == y.tobytes(), (what, f.name)
        else:
            assert x == y, (what, f.name)


@pytest.mark.parametrize("name", COLLECTIVE_SCENARIOS)
def test_registered_collective_tables_byte_equal(name):
    j, t = jscen.scenario(name), tscen.scenario(name)
    assert t.wl.n_deps > 0 and t.max_ticks == j.max_ticks
    _assert_tables_equal(j.wl, t.wl, name)


@pytest.mark.parametrize("gen,kw", [
    ("ring_allreduce", dict(chunk_bytes=4096, nodes=5, spread=True, start=7)),
    ("all_gather", dict(chunk_bytes=3000, nodes=16)),
    ("tree_allreduce", dict(msg_bytes=8192, nodes=13, branching=3)),
    ("tree_allreduce", dict(msg_bytes=8192, nodes=9, branching=1, spread=True)),
    ("pipeline", dict(stage_bytes=5000, stages=6, microbatches=3, start=2)),
], ids=lambda v: v if isinstance(v, str) else ",".join(f"{k}={x}" for k, x in v.items()))
def test_generators_byte_equal(gen, kw):
    tree = tscen.TREE_128_3T
    _assert_tables_equal(getattr(jcoll, gen)(tree, **kw), getattr(tcoll, gen)(tree, **kw),
                         gen)


@pytest.mark.parametrize("gen,kw", [("ring_allreduce", dict(chunk_bytes=1, nodes=1)),
                                    ("tree_allreduce", dict(msg_bytes=1, branching=0)),
                                    ("pipeline", dict(stage_bytes=1, stages=1,
                                                      microbatches=1))])
def test_generators_refuse_like_the_reference(gen, kw):
    tree = tscen.TREE_TINY
    with pytest.raises(ValueError):
        getattr(jcoll, gen)(tree, **kw)
    with pytest.raises(ValueError):
        getattr(tcoll, gen)(tree, **kw)


@pytest.mark.parametrize("name", ["tiny_allreduce_ring", "tiny_allgather",
                                  "tiny_pipeline", "pipeline_32n"])
def test_whole_collective_run_matches_reference(name):
    ts = assert_run_parity(name)
    assert tscen.scenario(name).build(device="cpu").dims.D > 0
    assert ts["all_done"]
