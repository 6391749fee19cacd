"""Transport-aware collective cost model: the bridge between the model
zoo's collectives and the paper's transport (the JAX package's
``collectives/bridge.py``, on the port's simulator).

A collective's traffic is replayed through the SMaRTT simulator — a
data-parallel all-reduce as a ring permutation over the oversubscribed
fabric, a MoE expert-parallel dispatch as a windowed all-to-all, the
paper's Sec. 4.4/4.5 workloads — and the achieved efficiency and
straggler spread come back under the transport asked for.  A roofline's
collective term can then be quoted under SMaRTT, Swift or EQDS instead
of an idealized link model.

The simulator is built on the card unless the caller passes
``device="cpu"``; the integer state runs bit-equal on both, so every
field of :class:`CollectiveEstimate` is the same wherever it ran.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.netsim import workloads
from repro_torch.netsim.engine import SimConfig, build, jain_fairness, summarize
from repro_torch.netsim.units import FatTreeConfig, LinkConfig


@dataclasses.dataclass(frozen=True)
class CollectiveEstimate:
    kind: str
    algo: str
    nodes: int
    wire_bytes_per_node: int
    ideal_ticks: int
    achieved_ticks: int
    efficiency: float          # ideal/achieved
    straggler_spread: float    # (max-min)/mean FCT
    trims: int
    fairness: float


# ring algorithms: bytes each node puts on the wire per collective
_WIRE_FACTOR = {
    "all-reduce": 2.0,         # reduce-scatter + all-gather, ~2x payload
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "collective-permute": 1.0,
    "all-to-all": 1.0,
}


def estimate(kind: str, bytes_per_device: float, *, algo: str = "smartt",
             nodes: int = 32, oversub: int = 4, lb: str = "reps",
             max_bytes: int = 2 << 20, seed: int = 0,
             device="cuda") -> CollectiveEstimate:
    """Simulate one collective over the cross-pod fabric.

    bytes_per_device: payload each participant contributes.  Scaled down to
    ``max_bytes`` (simulation budget) — efficiency is rate-like and stable
    in flow size once flows >> BDP.
    """
    if kind not in _WIRE_FACTOR:
        raise KeyError(kind)
    link = LinkConfig()
    per_rack = 16
    racks = max(nodes // per_rack, 2)
    tree = FatTreeConfig(racks=racks, nodes_per_rack=per_rack,
                         uplinks=max(per_rack // oversub, 1))
    n = tree.n_nodes

    wire = bytes_per_device * _WIRE_FACTOR[kind]
    size = int(min(wire, max_bytes))
    size = max(size // 4096 * 4096, 4096)

    if kind == "all-to-all":
        group = min(n, 16)
        pair = max(size // group // 4096 * 4096, 4096)
        wl = workloads.alltoall(tree, size_bytes=pair, window=4, nodes=group)
        bottleneck_pkts = (group - 1) * (pair // 4096) * \
            max(1, group // (per_rack * tree.uplinks // per_rack or 1))
    else:
        # ring neighbor exchange -> cross-rack permutation
        wl = workloads.permutation(tree, size_bytes=size, seed=seed)
        bottleneck_pkts = (size // 4096) * (per_rack // tree.uplinks)

    cfg = SimConfig(link=link, tree=tree, algo=algo, lb=lb)
    sim = build(cfg, wl, device=device)
    st = sim.run(max_ticks=1_000_000)
    s = summarize(sim, st)
    done = st.done.cpu().numpy()
    fct = s["fct_ticks"][done]
    ideal = bottleneck_pkts + sim.timing.brtt_inter
    achieved = int(fct.max()) if done.all() else 10 ** 9
    return CollectiveEstimate(
        kind=kind, algo=algo, nodes=n,
        wire_bytes_per_node=size,
        ideal_ticks=ideal,
        achieved_ticks=achieved,
        efficiency=min(ideal / achieved, 1.0) if achieved else 0.0,
        straggler_spread=float((fct.max() - fct.min()) / max(fct.mean(), 1)),
        trims=s["trims"],
        fairness=jain_fairness(fct),
    )


def refine_collective_term(t_collective_s: float, kind: str,
                           bytes_per_device: float, *, algo: str = "smartt",
                           **kw) -> dict:
    """Scale an idealized roofline collective term by the transport's
    achieved efficiency on that traffic pattern."""
    est = estimate(kind, bytes_per_device, algo=algo, **kw)
    eff = max(est.efficiency, 1e-3)
    return {
        "ideal_s": t_collective_s,
        "transport": algo,
        "efficiency": eff,
        "refined_s": t_collective_s / eff,
        "straggler_spread": est.straggler_spread,
        "trims": est.trims,
    }
