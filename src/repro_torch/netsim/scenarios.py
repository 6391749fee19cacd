"""Declarative scenario catalogue: named, frozen (config, workload,
max_ticks) bundles — the string-addressable entry points (DESIGN.md Sec. 7).

The names, trees and workloads are the reference's
(``repro/netsim/scenarios.py``), limited to the scenarios the port can
run: those with fault schedules (``perm_512n_3t_degraded``,
``corefail_128n_3t``, ``flap_128n_3t``, ``switchkill_128n_3t``) and those
with dependency tables (the collectives) wait for their modules::

    sc = scenario("perm_1024n_3t")
    sim = sc.build()                      # on the card
    st = sim.run(sc.max_ticks)
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.netsim import workloads
from repro_torch.netsim.state import SimConfig
from repro_torch.netsim.units import FatTreeConfig, LinkConfig
from repro_torch.netsim.workloads import Workload

KiB = 1024
MiB = 1024 * 1024

# Standard scaled topologies (EXPERIMENTS.md Sec. "Scaled topologies").
TREE_8TO1 = FatTreeConfig(racks=8, nodes_per_rack=16, uplinks=2)   # 128 nodes
TREE_4TO1 = FatTreeConfig(racks=4, nodes_per_rack=16, uplinks=4)   # 64 nodes
TREE_2TO1 = FatTreeConfig(racks=4, nodes_per_rack=16, uplinks=8)   # 64 nodes
TREE_FLAT = FatTreeConfig(racks=4, nodes_per_rack=8, uplinks=8)    # 32, 1:1
TREE_16 = FatTreeConfig(racks=2, nodes_per_rack=8, uplinks=2)      # 16, 4:1
TREE_TINY = FatTreeConfig(racks=2, nodes_per_rack=2, uplinks=2)    # 4 nodes

# Three-tier fat trees (pods of racks + a T2 core plane) — the paper's
# evaluation shape (Sec. 4: up to 1024 endpoints on a 3-tier
# oversubscribed fat tree).
TREE_1024_3T = FatTreeConfig(racks=128, nodes_per_rack=8, uplinks=4,
                             pods=8, core_uplinks=4)  # 1024 nodes — the
                                                      # paper's headline
                                                      # scale (Sec. 4)
TREE_512_3T = FatTreeConfig(racks=64, nodes_per_rack=8, uplinks=4,
                            pods=8, core_uplinks=4)   # 512 nodes, 2:1 x 2:1
TREE_128_3T = FatTreeConfig(racks=16, nodes_per_rack=8, uplinks=2,
                            pods=4, core_uplinks=2)   # 128 nodes, 4:1 x 2:1
TREE_3T_TINY = FatTreeConfig(racks=4, nodes_per_rack=2, uplinks=2,
                             pods=2, core_uplinks=2)  # 8 nodes, 1:1 x 1:1

LINK = LinkConfig()


@dataclasses.dataclass(frozen=True, eq=False)
class Scenario:
    """One named experiment setup: config + workload + tick budget."""

    name: str
    cfg: SimConfig
    wl: Workload
    max_ticks: int = 60_000

    def with_(self, *, name: str | None = None, max_ticks: int | None = None,
              wl: Workload | None = None, **cfg_overrides) -> "Scenario":
        """A copy with config fields (``algo=``, ``lb=``, backends ...),
        the workload, or the tick budget replaced."""
        cfg = (dataclasses.replace(self.cfg, **cfg_overrides)
               if cfg_overrides else self.cfg)
        return dataclasses.replace(
            self, cfg=cfg,
            name=self.name if name is None else name,
            max_ticks=self.max_ticks if max_ticks is None else int(max_ticks),
            wl=self.wl if wl is None else wl)

    def build(self, device="cuda"):
        """Build this scenario's simulator on ``device`` (the card unless
        the caller asks for the CPU)."""
        from repro_torch.netsim import engine
        return engine.build(self.cfg, self.wl, device=device)


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[[], Scenario]] = {}


def register(name: str, factory: Callable[[], Scenario], *aliases: str):
    """Register a scenario factory under ``name`` (and ``aliases``)."""
    for key in (name,) + aliases:
        if key in _REGISTRY:
            raise ValueError(f"scenario {key!r} already registered")
        _REGISTRY[key] = factory
    return factory


def names() -> tuple:
    """Registered scenario names, sorted."""
    return tuple(sorted(_REGISTRY))


def scenario(name: str, **overrides) -> Scenario:
    """Resolve a registered scenario by name; ``overrides`` are forwarded
    to :meth:`Scenario.with_` (config fields, ``max_ticks``)."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; registered: {', '.join(names())}"
        ) from None
    sc = factory()
    return sc.with_(**overrides) if overrides else sc


def _std(name: str, tree: FatTreeConfig, wl: Workload,
         max_ticks: int) -> Scenario:
    return Scenario(name=name, cfg=SimConfig(link=LINK, tree=tree),
                    wl=wl, max_ticks=max_ticks)


# --------------------------------------------------------------------------
# catalogue — the reference's names; keep stable
# --------------------------------------------------------------------------

# tiny smoke scenarios
register("tiny_incast3", lambda: _std(
    "tiny_incast3", TREE_TINY,
    workloads.incast(TREE_TINY, degree=3, size_bytes=16 * KiB, seed=0),
    20_000))
register("tiny_perm4", lambda: _std(
    "tiny_perm4", TREE_TINY,
    workloads.permutation(TREE_TINY, size_bytes=32 * KiB, seed=1),
    20_000))
register("tiny_sparse", lambda: _std(
    "tiny_sparse", TREE_TINY,
    workloads.heavy_tailed(TREE_TINY, 8, size_base=8 * KiB,
                           size_cap=256 * KiB, gap_mean=1500.0, seed=1),
    30_000))

# dense standard scenarios
register("incast8_32n", lambda: _std(
    "incast8_32n", TREE_FLAT,
    workloads.incast(TREE_FLAT, degree=8, size_bytes=512 * KiB, seed=0),
    60_000), "incast_8x1_32n")
register("incast_32x1", lambda: _std(
    "incast_32x1", TREE_4TO1,
    workloads.incast(TREE_4TO1, degree=32, size_bytes=256 * KiB, seed=0),
    60_000))
register("perm64", lambda: _std(
    "perm64", TREE_4TO1,
    workloads.permutation(TREE_4TO1, size_bytes=2 * MiB, seed=7),
    60_000), "perm_64n")
register("perm128_8to1", lambda: _std(
    "perm128_8to1", TREE_8TO1,
    workloads.permutation(TREE_8TO1, size_bytes=512 * KiB, seed=7),
    120_000))
register("alltoall16_w4", lambda: _std(
    "alltoall16_w4", TREE_4TO1,
    workloads.alltoall(TREE_4TO1, size_bytes=64 * KiB, window=4, nodes=16),
    200_000))

# small 4:1 grid for tuning studies
register("incast8_16n", lambda: _std(
    "incast8_16n", TREE_16,
    workloads.incast(TREE_16, degree=8, size_bytes=64 * 4096, seed=3),
    60_000))
register("perm_16n", lambda: _std(
    "perm_16n", TREE_16,
    workloads.permutation(TREE_16, size_bytes=64 * 4096, seed=3),
    60_000))

# three-tier scenarios (paper-scale fabrics)
register("tiny_3t", lambda: _std(
    "tiny_3t", TREE_3T_TINY,
    workloads.permutation(TREE_3T_TINY, size_bytes=16 * KiB, seed=1),
    20_000))
register("perm_512n_3t", lambda: _std(
    "perm_512n_3t", TREE_512_3T,
    workloads.permutation(TREE_512_3T, size_bytes=256 * KiB, seed=7),
    60_000))
register("perm_1024n_3t", lambda: _std(
    "perm_1024n_3t", TREE_1024_3T,
    workloads.permutation(TREE_1024_3T, size_bytes=256 * KiB, seed=7),
    60_000))
register("incast_256x1_3t", lambda: _std(
    "incast_256x1_3t", TREE_512_3T,
    workloads.incast(TREE_512_3T, degree=256, size_bytes=32 * KiB, seed=0),
    60_000))
register("alltoall_3t", lambda: _std(
    "alltoall_3t", TREE_512_3T,
    workloads.alltoall(TREE_512_3T, size_bytes=32 * KiB, window=4,
                       nodes=32, spread=True),
    200_000))
register("perm_128n_3t", lambda: _std(
    "perm_128n_3t", TREE_128_3T,
    workloads.permutation(TREE_128_3T, size_bytes=256 * KiB, seed=7),
    120_000))

# sparse/large-message scenarios (event-horizon leap targets, DESIGN 6.3)
register("sparse_heavy_32n", lambda: _std(
    "sparse_heavy_32n", TREE_FLAT,
    workloads.heavy_tailed(TREE_FLAT, 24, size_base=16 * KiB,
                           size_cap=2 * MiB, gap_mean=2500.0, seed=3),
    100_000))
register("sparse_large_32n", lambda: _std(
    "sparse_large_32n", TREE_FLAT,
    workloads.staggered_large(TREE_FLAT, 8, 2 * MiB, gap_ticks=6000, seed=0),
    100_000))
