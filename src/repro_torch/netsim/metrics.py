"""Phase 6 — metrics accounting — plus the host-side result extraction.

``Metrics`` is the per-run counter bundle threaded through every phase;
``account`` is the end-of-tick occupancy accounting; ``summarize`` pulls a
finished run back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

I32 = torch.int32
F32 = torch.float32

HIST_BINS = 64     # RTT histogram bins, width = brtt/8
GOODPUT_BINS = 64  # delivered-bytes history bins (Consts.goodput_bin
                   # ticks wide; drives the recovery dip/TTR metrics)


class Metrics(NamedTuple):
    n_trim: torch.Tensor
    n_drop: torch.Tensor
    n_black: torch.Tensor
    n_to: torch.Tensor
    n_retx: torch.Tensor
    n_ack: torch.Tensor
    delivered_pkts: torch.Tensor
    delivered_bytes: torch.Tensor
    rtt_hist: torch.Tensor        # [HIST_BINS]
    q_sum: torch.Tensor           # sum over (ticks, ports) of occupancy
    q_max: torch.Tensor
    spurious_retx: torch.Tensor   # retransmitted packets that had been delivered
    # recovery metrics (only accrued when a fault schedule is present)
    delivered_bytes_fault: torch.Tensor  # bytes delivered while fault-active
    goodput_hist: torch.Tensor           # f32 [GOODPUT_BINS] binned bytes


def init_metrics(device, lead: tuple = ()) -> Metrics:
    lead = tuple(lead)
    i = lambda: torch.zeros(lead, dtype=I32, device=device)
    f = lambda: torch.zeros(lead, dtype=F32, device=device)
    return Metrics(
        n_trim=i(),
        n_drop=i(),
        n_black=i(),
        n_to=i(),
        n_retx=i(),
        n_ack=i(),
        delivered_pkts=i(),
        delivered_bytes=f(),
        rtt_hist=torch.zeros(lead + (HIST_BINS,), dtype=I32, device=device),
        q_sum=f(),
        q_max=i(),
        spurious_retx=i(),
        delivered_bytes_fault=f(),
        goodput_hist=torch.zeros(lead + (GOODPUT_BINS,), dtype=F32, device=device),
    )


def isum(x, dim=None):
    """Integer sum kept in i32, as the reference's ``jnp.sum`` of i32/bool
    is (``torch.sum`` would widen to i64)."""
    if dim is None:
        return torch.sum(x, dtype=I32)
    return torch.sum(x, dim=dim, dtype=I32)


def account(dims, consts, st, k):
    """Phase 6: per-tick occupancy accounting over the fabric queues, one
    row a lane (``k`` is the batch's ``kernels.lanes.Tick``); a lane that
    is not live is left as it was."""
    del consts
    m = st.m
    q = st.q_size[..., :dims.NQ]
    q_sum = m.q_sum + isum(q, -1).to(F32)
    q_max = torch.maximum(m.q_max, torch.amax(q, dim=-1))
    if not k.all_live:
        q_sum = torch.where(k.live, q_sum, m.q_sum)
        q_max = torch.where(k.live, q_max, m.q_max)
    return st._replace(m=m._replace(q_sum=q_sum, q_max=q_max))


def leap_account(m: Metrics, dt, occupancy) -> Metrics:
    """Closed-form ``dt``-tick occupancy integral for a time leap
    (DESIGN.md Sec. 6.3): the linear form ``dt * occupancy`` replaces
    ``dt`` sequential executions of ``account``.  ``dt`` and ``occupancy``
    are one per lane (i32 ``[L]``); a lane with ``dt == 0`` is left as it
    was.

    Bitwise exact, not approximate: the leap predicate only yields
    ``dt > 0`` with every port empty (an occupied port departs every
    tick), so the integral contributes exactly 0.0 and ``q_max`` — the
    running max of an unchanged occupancy — needs no update.
    """
    return m._replace(q_sum=torch.where(
        dt > 0, m.q_sum + dt.to(F32) * occupancy.to(F32), m.q_sum))


# --------------------------------------------------------------------------
# result extraction
# --------------------------------------------------------------------------


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def summarize(sim, st) -> dict:
    """Pull host-side summary statistics from a finished run (its state on
    the device or on the host)."""
    fct = _host(st.fct)
    done = _host(st.done)
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
        goodput_hist=_host(m.goodput_hist),
        spurious_retx=int(m.spurious_retx),
        rtt_hist=_host(m.rtt_hist),
        q_mean=float(m.q_sum) / max(1, int(st.now)) / sim.dims.NQ,
        q_max=int(m.q_max),
        goodput_bytes=_host(st.goodput),
    )
    total_pkts = max(1, int(m.delivered_pkts))
    out["spurious_frac"] = out["spurious_retx"] / total_pkts
    out["mtu"] = mtu
    return out


def jain_fairness(values: np.ndarray) -> float:
    v = np.asarray(values, np.float64)
    if v.sum() == 0:
        return 1.0
    return float(v.sum() ** 2 / (len(v) * (v ** 2).sum()))
