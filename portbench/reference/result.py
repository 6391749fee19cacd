"""A lane's result row, worked out from the reference's final state: the
arithmetic of the simulator's ``RunResult.from_state(...).row()`` for a
run without a fault schedule (the benchmark's configurations have none),
in NumPy."""

from __future__ import annotations

import numpy as np

from .metrics import jain_fairness


def point_tag(point: dict) -> str:
    kv = sorted(dict(point).items())
    return "+".join(f"{k}={v:g}" for k, v in kv) if kv else "base"


def row(sim, st, *, scenario: str, point: dict, seed: int, max_ticks: int) -> dict:
    """The row of one finished lane: ``sim`` the reference's simulator of
    its point, ``st`` its final state."""
    if sim.cfg.faults:
        raise ValueError("the reference's rows cover runs without a fault schedule")
    m = st.m
    now = int(st.now)
    fct, done = np.asarray(st.fct), np.asarray(st.done)
    size = np.asarray(sim.consts.size)
    t_start = np.asarray(sim.consts.t_start)
    flow_brtt = np.asarray(sim.consts.cc.brtt)
    n_done = int(done.sum())
    fct_done = fct[done]
    ideal = np.maximum(-(-size.astype(np.int64) // sim.dims.mtu) - 1
                       + flow_brtt.astype(np.float64), 1.0)
    slowdown = np.where(done, fct / ideal.astype(np.float64), np.nan)
    delivered_pkts = int(m.delivered_pkts)
    q_mean = float(m.q_sum) / max(1, now) / sim.dims.NQ
    d = dict(
        name=f"{scenario}/{sim.cfg.algo}+{sim.cfg.lb}[{point_tag(point)}]/s{int(seed)}",
        scenario=scenario, algo=sim.cfg.algo, lb=sim.cfg.lb,
        point=dict(sorted(dict(point).items())), seed=int(seed),
        max_ticks=int(max_ticks), ticks=now, n_flows=int(fct.shape[0]), n_done=n_done,
        all_done=bool(done.all()),
        completion=int(fct_done.max()) if n_done else -1,
        fct_mean=round(float(fct_done.mean()) if n_done else -1.0, 3),
        fct_p99=round(float(np.percentile(fct_done, 99)) if n_done else -1.0, 3),
        jain=round(jain_fairness(fct_done) if n_done else 0.0, 6),
        slowdown_mean=round(float(np.nanmean(slowdown)) if n_done else -1.0, 6),
        slowdown_p99=round(float(np.nanpercentile(slowdown, 99)) if n_done else -1.0, 6),
        trims=int(m.n_trim), drops=int(m.n_drop), blackholed=int(m.n_black),
        timeouts=int(m.n_to), retx=int(m.n_retx),
        spurious_frac=round(int(m.spurious_retx) / max(1, delivered_pkts), 6),
        delivered_bytes=float(m.delivered_bytes),
        q_mean=round(q_mean, 6), q_max=int(m.q_max),
    )
    coll = sim.wl.coll_id
    if coll is not None and np.any(np.asarray(coll) >= 0):
        coll = np.asarray(coll)
        finish = fct.astype(np.int64) + t_start
        ccts = {}
        for c in np.unique(coll[coll >= 0]):
            k = coll == c
            ccts[int(c)] = (int(finish[k].max() - t_start[k].min()) if done[k].all() else -1)
        d.update(cct=-1 if not ccts or any(v < 0 for v in ccts.values()) else max(ccts.values()),
                 n_collectives=len(ccts))
    return d
