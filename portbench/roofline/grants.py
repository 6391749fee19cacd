"""Bytes the grants phase (``sender.grants``: EQDS's receivers granting
pull credit) must move, however it is built.

Per live lane-tick: each flow's demand inputs (its start tick, done flag,
goodput, bytes granted and trimmed bytes seen, and its dependency words
where the workload has them), the lane's tick and credit window, and the
cursor of each receiver that has a flow.  Per grant: the credit ring word
and the ``granted`` word it adds to, and the receiver's cursor it moves.
The ``[N, FRMAX]`` table of each receiver's flows is not counted, so a
design that hands the pick only the receivers that have a flow is judged
on the same work as one that hands it every node.  Grants are counted
from below: a flow sends each of its bytes at least once, on its
speculative budget (one BDP) or on credit granted to it, so it was
granted at least its size less one BDP, in MTUs.  The predicate's few
float operations a flow are left out: the phase is bound by bytes.
"""

from __future__ import annotations

import numpy as np

I = 4


def workload(run) -> dict:
    """What the count needs of the cell's flow table: the receivers that
    have a flow, and the least grants a lane makes.  The generator draws
    only the arrangement from its seed (``gen/traffic.py``), so any seed
    gives the same counts."""
    from portbench import harness
    from portbench.gen import traffic
    from portbench.reference import check, engine, state, workloads

    table = traffic.flows(run.config["fabric"], run.mix["traffic"], 0)
    cfg = engine.apply_point(check.sim_config(run.config), harness.points_of(run.mix)[0])
    wl = workloads.Workload(name="grants", src=table["src"], dst=table["dst"],
                            size=table["size"], t_start=table["t_start"],
                            order=table["order"], window=table["window"])
    _, _, d, _ = state.derive(cfg, wl)
    owed = np.maximum(table["size"].astype(np.int64) - int(d.bdp_bytes), 0)
    return dict(receivers=int(np.unique(table["dst"]).size),
                grants=int((-(-owed // int(d.mtu))).sum()))


def lane_tick_bytes(s: dict, receivers: int) -> int:
    """Bytes of one live lane-tick that do not depend on the data."""
    flow = 4 * I + 1 + 2 * s["D"] * I        # t_start goodput granted trim_seen, done, deps
    return s["NF"] * flow + 2 * I + receivers * I


def study_bytes(s: dict, lane_ticks: int, lanes: int, w: dict) -> tuple:
    """``(bytes, f32 operations)`` of a study's grants phases:
    ``lane_ticks`` live lane-ticks, ``lanes`` lanes, ``w`` from
    :func:`workload`."""
    return lane_tick_bytes(s, w["receivers"]) * lane_ticks + lanes * w["grants"] * 3 * I, 0.0
