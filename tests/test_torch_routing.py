"""PyTorch port, table-driven routing: ``fabric.route_switch``,
``route_from_sender`` and ``route_step`` against the JAX package's, and
the reference's routing properties on the port's own functions.

  * every (flow, entropy) of an all-pairs workload is delivered to its
    destination in the analytic hop count, never revisiting a port, and
    the walk is the reference's queue for queue (the twin of
    ``tests/test_topology.py::test_routing_reaches_dst_loop_free_with_coverage``);
  * on the two-tier catalogue trees the first hop equals the historical
    closed form (the twin of
    ``test_two_tier_table_routing_equals_closed_form``);
  * ``route_first_hop`` (the tick's all-flows form) equals
    ``route_from_sender`` over every flow;
  * ``route_switch`` equals the reference's on every (switch, node,
    entropy) of a seeded grid.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.netsim import fabric as jfabric  # noqa: E402
from repro.netsim.scenarios import (TREE_2TO1, TREE_4TO1, TREE_8TO1,  # noqa: E402
                                    TREE_16, TREE_FLAT, TREE_TINY)
from repro.netsim.units import path_queues  # noqa: E402
from repro_torch.netsim import fabric as tfabric  # noqa: E402
from repro_torch.netsim import state as tstate  # noqa: E402
from repro_torch.netsim import units as tunits  # noqa: E402
from repro_torch.netsim import workloads as tworkloads  # noqa: E402
from test_topology import (RANDOM_TREES, _all_pairs_workload,  # noqa: E402
                           _closed_form_from_sender, _derive)

I32 = torch.int32
TWO_TIER = [TREE_TINY, TREE_16, TREE_FLAT, TREE_2TO1, TREE_4TO1, TREE_8TO1]


def _both(tree, rng):
    """The reference's and the port's (dims, consts) of one all-pairs
    workload on ``tree`` (the port's on the CPU)."""
    wl = _all_pairs_workload(tree, rng)
    _, _, jdims, jconsts = _derive(tree, wl)
    ttree = tunits.FatTreeConfig(**dataclasses.asdict(tree))
    twl = tworkloads.Workload(name=wl.name, src=wl.src, dst=wl.dst, size=wl.size,
                              t_start=wl.t_start, order=wl.order)
    _, _, tdims, tconsts = tstate.derive(tstate.SimConfig(tree=ttree), twl, "cpu")
    return wl, jdims, jconsts, tdims, tconsts


def _walk(dims, consts, ents):
    """Every flow for every entropy from its sender NIC to delivery through
    the port's routing: the queue at each step [H+1, NF, E] (delivery
    negative, sticky once reached)."""
    e = torch.as_tensor(ents, dtype=I32)[None, :]
    f = torch.arange(dims.NF, dtype=I32)[:, None]
    d = consts.dst[:, None]
    q = tfabric.route_from_sender(dims, consts, f, e)
    hops = [q.numpy()]
    for _ in range(7):           # the longest legal path is 5 queues
        nxt = tfabric.route_step(dims, consts, q.clamp(0, dims.NQ - 1), d, e)
        q = torch.where(q >= 0, nxt, q)
        hops.append(q.numpy())
    return np.stack(hops)


def _reference_walk(dims, consts, ents):
    e = jnp.asarray(ents, jnp.int32)[None, :]
    f = jnp.arange(dims.NF, dtype=jnp.int32)[:, None]
    d = consts.dst[:, None]
    q = jfabric.route_from_sender(dims, consts, f, e)
    hops = [np.asarray(q)]
    for _ in range(7):
        nxt = jfabric.route_step(dims, consts, jnp.clip(q, 0, dims.NQ - 1), d, e)
        q = jnp.where(q >= 0, nxt, q)
        hops.append(np.asarray(q))
    return np.stack(hops)


@pytest.mark.parametrize("tree", RANDOM_TREES,
                         ids=[f"t{t.tiers}_{t.n_nodes}n" for t in RANDOM_TREES])
def test_routing_reaches_dst_loop_free(tree):
    wl, jdims, jconsts, dims, consts = _both(tree, np.random.default_rng(1))
    ents = np.arange(32, dtype=np.int32)
    hops = _walk(dims, consts, ents)
    np.testing.assert_array_equal(hops, _reference_walk(jdims, jconsts, ents))
    # delivered: the final entry is -(dst + 1) for every (flow, entropy)
    want = -(consts.dst.numpy()[:, None] + 1)
    np.testing.assert_array_equal(hops[-1], np.broadcast_to(want, hops[-1].shape))
    # the analytic hop count of each path class
    h_intra, h_pod, h_inter = path_queues(tree)
    M, Pg = tree.nodes_per_rack, tree.racks_per_pod
    sr, dr = wl.src // M, wl.dst // M
    expect = np.where(sr == dr, h_intra, np.where(sr // Pg == dr // Pg, h_pod, h_inter))
    np.testing.assert_array_equal(np.sum(hops >= 0, axis=0),
                                  np.broadcast_to(expect[:, None], hops.shape[1:]))
    # loop-free and in range
    valid = hops >= 0
    assert np.all(hops[valid] < dims.NQ)
    s = np.sort(np.where(valid, hops, -np.arange(hops.shape[0])[:, None, None] - 1), axis=0)
    assert np.all((s[1:] != s[:-1]) | (s[1:] < 0)), "a path revisited a port"


@pytest.mark.parametrize("tree", TWO_TIER, ids=["tiny", "16", "flat", "2to1", "4to1", "8to1"])
def test_two_tier_first_hop_equals_closed_form(tree):
    _, jdims, jconsts, dims, consts = _both(tree, np.random.default_rng(3))
    ents = np.arange(64, dtype=np.int32)
    f = np.arange(dims.NF, dtype=np.int32)[:, None]
    got = tfabric.route_from_sender(dims, consts, torch.from_numpy(f),
                                    torch.from_numpy(ents)[None, :]).numpy()
    want = _closed_form_from_sender(jdims, jconsts, np.broadcast_to(f, got.shape),
                                    np.broadcast_to(ents[None, :], got.shape))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tree", RANDOM_TREES[::2] + [TREE_2TO1],
                         ids=lambda t: f"t{t.tiers}_{t.n_nodes}n")
def test_first_hop_of_every_flow_equals_route_from_sender(tree):
    _, _, _, dims, consts = _both(tree, np.random.default_rng(5))
    rng = np.random.default_rng(7)
    for _ in range(4):
        ent = torch.from_numpy(rng.integers(-2**31, 2**31, dims.NF, dtype=np.int64)
                               .astype(np.int32))
        torch.testing.assert_close(
            tfabric.route_first_hop(dims, consts, ent),
            tfabric.route_from_sender(dims, consts, consts.flow_ids, ent), rtol=0, atol=0)


@pytest.mark.parametrize("tree", RANDOM_TREES, ids=[f"t{t.tiers}_{t.n_nodes}n"
                                                    for t in RANDOM_TREES])
def test_route_switch_matches_reference(tree):
    _, jdims, jconsts, dims, consts = _both(tree, np.random.default_rng(2))
    rng = np.random.default_rng(11)
    nsw = consts.sw_lo.shape[0]
    sw = rng.integers(0, nsw, (64, 1)).astype(np.int32)
    d = rng.integers(0, tree.n_nodes, (64, 1)).astype(np.int32)
    ent = rng.integers(-2**31, 2**31, (1, 48), dtype=np.int64).astype(np.int32)
    got = tfabric.route_switch(dims, consts, torch.from_numpy(sw), torch.from_numpy(d),
                               torch.from_numpy(ent)).numpy()
    want = np.asarray(jfabric.route_switch(jdims, jconsts, jnp.asarray(sw), jnp.asarray(d),
                                           jnp.asarray(ent)))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
