"""Phase 6 — metrics accounting — plus the host-side result extraction.

``Metrics`` is the per-run counter bundle threaded through every phase;
``account`` is the end-of-tick occupancy accounting; ``summarize`` pulls a
finished run back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

from . import np32 as jnp
import numpy as np

I32 = jnp.int32
F32 = jnp.float32

HIST_BINS = 64     # RTT histogram bins, width = brtt/8
GOODPUT_BINS = 64  # delivered-bytes history bins (Consts.goodput_bin
                   # ticks wide; drives the recovery dip/TTR metrics)


class Metrics(NamedTuple):
    n_trim: jnp.ndarray
    n_drop: jnp.ndarray
    n_black: jnp.ndarray
    n_to: jnp.ndarray
    n_retx: jnp.ndarray
    n_ack: jnp.ndarray
    delivered_pkts: jnp.ndarray
    delivered_bytes: jnp.ndarray
    rtt_hist: jnp.ndarray        # [HIST_BINS]
    q_sum: jnp.ndarray           # sum over (ticks, ports) of occupancy
    q_max: jnp.ndarray
    spurious_retx: jnp.ndarray   # retransmitted packets that had been delivered
    # recovery metrics (only accrued when a fault schedule is present;
    # updated exclusively on delivery ticks, so leap-exact with no
    # leap_account term)
    delivered_bytes_fault: jnp.ndarray  # bytes delivered while fault-active
    goodput_hist: jnp.ndarray           # f32 [GOODPUT_BINS] binned bytes


def init_metrics() -> Metrics:
    i = lambda: jnp.zeros((), I32)
    f = lambda: jnp.zeros((), F32)
    return Metrics(
        n_trim=i(),
        n_drop=i(),
        n_black=i(),
        n_to=i(),
        n_retx=i(),
        n_ack=i(),
        delivered_pkts=i(),
        delivered_bytes=f(),
        rtt_hist=jnp.zeros((HIST_BINS,), I32),
        q_sum=f(),
        q_max=i(),
        spurious_retx=i(),
        delivered_bytes_fault=f(),
        goodput_hist=jnp.zeros((GOODPUT_BINS,), F32),
    )


def account(dims, consts, st):
    """Phase 6: per-tick occupancy accounting over the fabric queues."""
    del consts
    m = st.m
    q = st.q_size[:dims.NQ]
    m = m._replace(
        q_sum=m.q_sum + jnp.sum(q).astype(F32),
        q_max=jnp.maximum(m.q_max, jnp.max(q)),
    )
    return st._replace(m=m)


def leap_account(m: Metrics, dt, occupancy) -> Metrics:
    """Closed-form ``dt``-tick occupancy integral for a time leap
    (DESIGN.md Sec. 6.3): the linear form ``dt * occupancy`` replaces
    ``dt`` sequential executions of ``account``.

    Bitwise exact, not approximate: the leap predicate only yields
    ``dt > 0`` with every port empty (an occupied port departs every
    tick), so the integral contributes exactly 0.0 and ``q_max`` — the
    running max of an unchanged occupancy — needs no update.  Broadcasts
    over a leading batch axis (``occupancy`` per element, scalar ``dt``).
    """
    return m._replace(
        q_sum=m.q_sum + dt.astype(F32) * occupancy.astype(F32))


# --------------------------------------------------------------------------
# result extraction
# --------------------------------------------------------------------------


def summarize(sim, st) -> dict:
    """Pull host-side summary statistics from a finished run."""
    fct = np.asarray(st.fct)
    done = np.asarray(st.done)
    mtu = sim.dims.mtu
    m = st.m
    out = dict(
        ticks=int(st.now),
        all_done=bool(done.all()),
        n_done=int(done.sum()),
        fct_ticks=fct,
        fct_max=int(fct.max()) if done.any() else -1,
        fct_min=int(fct[done].min()) if done.any() else -1,
        fct_mean=float(fct[done].mean()) if done.any() else -1.0,
        fct_p99=float(np.percentile(fct[done], 99)) if done.any() else -1.0,
        spread=float(fct[done].max() - fct[done].min()) if done.any() else -1.0,
        trims=int(m.n_trim), drops=int(m.n_drop), blackholed=int(m.n_black),
        timeouts=int(m.n_to), retx=int(m.n_retx), acks=int(m.n_ack),
        delivered_bytes=float(m.delivered_bytes),
        delivered_bytes_fault=float(m.delivered_bytes_fault),
        goodput_hist=np.asarray(m.goodput_hist),
        spurious_retx=int(m.spurious_retx),
        rtt_hist=np.asarray(m.rtt_hist),
        q_mean=float(m.q_sum) / max(1, int(st.now)) / sim.dims.NQ,
        q_max=int(m.q_max),
        goodput_bytes=np.asarray(st.goodput),
    )
    total_pkts = max(1, int(m.delivered_pkts))
    out["spurious_frac"] = out["spurious_retx"] / total_pkts
    # ideal completion: bytes through the tightest static bottleneck
    out["mtu"] = mtu
    return out


def jain_fairness(values: np.ndarray) -> float:
    v = np.asarray(values, np.float64)
    if v.sum() == 0:
        return 1.0
    return float(v.sum() ** 2 / (len(v) * (v ** 2).sum()))
