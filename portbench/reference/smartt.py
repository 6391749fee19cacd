"""SMaRTT congestion control — faithful vectorized form of the paper's
Algorithms 1 (main loop), 2 (QuickAdapt) and 3 (FastIncrease).

Every equation/constant maps 1:1 onto the paper:

  Fair Decrease            Eq. 1   cwnd -= cwnd/bdp * fd * p.size
  Multiplicative Decrease  Eq. 2   cwnd -= min(p.size, (rtt-trtt)/rtt * md * p.size)  [+ FD]
  Fair Increase            Eq. 3   cwnd += p.size/cwnd * mtu * fi
  Multiplicative Increase  Eq. 4   cwnd += min(p.size, (trtt-rtt)/rtt * p.size/cwnd * mtu * mi) [+ FI]
  QuickAdapt               Alg. 2  cwnd  = max(acked_last_trtt, mtu) * qa_scaling
  FastIncrease             Alg. 3  cwnd += k * mtu per uncongested ACK
  Wait-to-Decrease         3.6.1   no decrease while EWMA(ecn) < 0.25
  clamp                    l. 36   cwnd in [mtu, 1.25*bdp]

The functions are shape-polymorphic over the flow dimension and free of
data-dependent control flow, so the same code serves as (a) the engine's
per-tick update, (b) the pure-jnp oracle for the ``kernels/cc_update``
Pallas kernel (see ``kernels/cc_update/ref.py``).
"""

from __future__ import annotations

from . import np32 as jnp

from .cctypes import CCEvent, CCParams, CCState
from .units import HDR_BYTES


def quick_adapt(p: CCParams, s: CCState, unacked, now, gate):
    """Alg. 2.  ``gate`` masks flows for which quick_adapt() is invoked this
    tick (l. 13 on ACKs; l. 33 on trims when outside the ignore phase).
    Returns (state', adapted)."""
    now = jnp.asarray(now, jnp.float32)
    boundary = gate & (now >= s.qa_end)
    fire = boundary & s.trigger_qa & (s.qa_end != 0.0)
    cwnd = jnp.where(fire, jnp.maximum(s.acked, p.mtu) * p.qa_scaling, s.cwnd)
    bytes_to_ignore = jnp.where(fire, unacked, s.bytes_to_ignore)
    bytes_ignored = jnp.where(fire, 0.0, s.bytes_ignored)
    trigger_qa = jnp.where(fire, False, s.trigger_qa)
    qa_end = jnp.where(boundary, now + p.trtt, s.qa_end)
    acked = jnp.where(boundary, 0.0, s.acked)
    s = s._replace(
        cwnd=cwnd,
        bytes_to_ignore=bytes_to_ignore,
        bytes_ignored=bytes_ignored,
        trigger_qa=trigger_qa,
        qa_end=qa_end,
        acked=acked,
    )
    return s, fire


def fast_increase(p: CCParams, s: CCState, ecn, rtt, size, gate):
    """Alg. 3.  Returns (state', increase_active)."""
    near_base = gate & (~ecn) & (rtt <= p.brtt * p.fi_rtt_tol + 1.0)
    count = jnp.where(near_base, s.fi_count + size, 0.0)
    active = near_base & ((count > s.cwnd) | s.fi_active)
    cwnd = jnp.where(active, s.cwnd + p.k_fast * p.mtu, s.cwnd)
    fi_active = jnp.where(gate, active, s.fi_active)
    fi_count = jnp.where(gate, count, s.fi_count)
    return s._replace(cwnd=cwnd, fi_active=fi_active, fi_count=fi_count), active


def smartt_update(p: CCParams, s: CCState, ev: CCEvent, now) -> CCState:
    """One tick of Alg. 1 for every flow.

    Event composition order inside a tick: the (single) ACK first, then
    trim/timeout notifications — mirroring distinct events in an
    event-driven simulator; see DESIGN.md Sec. 6.
    """
    now = jnp.asarray(now, jnp.float32)

    # ---------------- ACK branch (Alg. 1 l. 7-27) ----------------
    has = ev.has_ack
    size = jnp.where(has, ev.ack_bytes, 0.0)

    # l. 4-5: every received control packet counts toward `acked` and the
    # QuickAdapt ignore budget.
    s = s._replace(
        acked=s.acked + size,
        bytes_ignored=s.bytes_ignored + size,
    )
    # l. 8-10: swallow ACKs sent before QuickAdapt's adjustment propagated.
    ignoring = s.bytes_ignored < s.bytes_to_ignore
    act = has & ~ignoring

    # reaction granularity (Fig. 3b): CC reacts every `react_every` ACKs.
    ack_count = s.ack_count + act.astype(jnp.int32)
    react = act & (ack_count % jnp.maximum(p.react_every, 1) == 0)
    s = s._replace(ack_count=ack_count)

    # l. 11: Wait-to-Decrease (Sec. 3.6.1)
    ecn_f = ev.ecn.astype(jnp.float32)
    avg_wtd = jnp.where(act, p.wtd_alpha * ecn_f + (1.0 - p.wtd_alpha) * s.avg_wtd, s.avg_wtd)
    s = s._replace(avg_wtd=avg_wtd)
    can_decrease = avg_wtd >= p.wtd_thresh

    # l. 13-14: QuickAdapt & FastIncrease
    s, adp = quick_adapt(p, s, ev.unacked, now, gate=act)
    s, finc = fast_increase(p, s, ev.ecn, ev.rtt, size, gate=act)

    # l. 19-27: the four window actions
    go = react & ~(adp | finc)
    rtt = jnp.maximum(ev.rtt, 1e-6)
    cwnd = jnp.maximum(s.cwnd, 1.0)

    fd_amt = cwnd / p.bdp * p.fd * size                              # Eq. 1
    md_amt = jnp.minimum(size, (rtt - p.trtt) / rtt * p.md * size)   # Eq. 2
    fi_amt = size / cwnd * p.mtu * p.fi                              # Eq. 3
    mi_amt = jnp.minimum(size, (p.trtt - rtt) / rtt * size / cwnd * p.mtu * p.mi)  # Eq. 4

    is_fd = go & ev.ecn & (rtt <= p.trtt) & can_decrease
    is_md = go & ev.ecn & (rtt > p.trtt) & can_decrease
    is_fi = go & ~ev.ecn & (rtt > p.trtt)
    is_mi = go & ~ev.ecn & (rtt <= p.trtt)

    delta = (
        -fd_amt * is_fd
        - (md_amt + fd_amt) * is_md          # MD additionally applies FD (Sec. 3.2.2)
        + fi_amt * is_fi
        + (mi_amt + fi_amt) * is_mi          # MI additionally applies FI (Sec. 3.2.4)
    )
    s = s._replace(cwnd=s.cwnd + delta)

    # ---------------- trim / timeout branch (Alg. 1 l. 28-35) ----------------
    n_loss = ev.n_trims + ev.n_timeouts
    lost = n_loss > 0
    lost_bytes = ev.trim_bytes + ev.to_bytes
    # trimmed *headers* are received packets -> l. 4-5 bookkeeping
    hdr_bytes = HDR_BYTES * ev.n_trims.astype(jnp.float32)
    s = s._replace(
        acked=s.acked + hdr_bytes,
        bytes_ignored=s.bytes_ignored + hdr_bytes,
        cwnd=s.cwnd - jnp.where(lost, lost_bytes, 0.0),     # l. 29
        trigger_qa=s.trigger_qa | lost,                      # l. 30
    )
    # l. 32-34: QuickAdapt unless still ignoring post-QA feedback
    qa_gate = lost & (s.bytes_ignored >= s.bytes_to_ignore)
    s, _ = quick_adapt(p, s, ev.unacked, now, gate=qa_gate)

    # l. 36: clamp
    s = s._replace(cwnd=jnp.clip(s.cwnd, p.mincwnd, p.maxcwnd))
    return s
