"""Baseline congestion-control algorithms the paper compares against
(Sec. 4): Swift, MPRDMA, BBR, EQDS — plus the single-signal strawmen of
Fig. 2/3 (ECN-only, delay-only) and the EQDS+SMaRTT hybrid of Sec. 5.1.

These are deliberately compact, faithful-in-spirit re-implementations (the
paper itself uses htsim's versions): each reproduces the property the paper
leans on — Swift's once-per-RTT delay MD, MPRDMA's per-packet ECN reaction
and its unfairness, BBR's slow bandwidth-probe convergence, EQDS's
receiver-credit pacing with no fabric CC.  Simplifications are listed in
DESIGN.md Sec. 2.
"""

from __future__ import annotations

from . import np32 as jnp

from .cctypes import CCEvent, CCParams, CCState


def _loss_event(ev: CCEvent):
    return (ev.n_trims + ev.n_timeouts) > 0


def swift_update(p: CCParams, s: CCState, ev: CCEvent, now) -> CCState:
    """Swift [37]: delay-based AIMD with per-RTT multiplicative decrease.

    target delay = trtt (flow-scaled terms elided); additive increase
    sw_ai MTU per RTT; decrease factor 1 - beta*(rtt-t)/rtt clamped to
    sw_max_mdf, at most once per RTT.
    """
    now = jnp.asarray(now, jnp.float32)
    rtt = jnp.maximum(ev.rtt, 1e-6)
    cwnd = jnp.maximum(s.cwnd, 1.0)
    can_dec = (now - s.last_dec) >= rtt

    inc = p.sw_ai * p.mtu * ev.ack_bytes / cwnd
    mdf = jnp.maximum(1.0 - p.sw_beta * (rtt - p.trtt) / rtt, 1.0 - p.sw_max_mdf)

    slow = ev.rtt > p.trtt
    new_cwnd = jnp.where(
        ev.has_ack & ~slow, s.cwnd + inc,
        jnp.where(ev.has_ack & slow & can_dec, s.cwnd * mdf, s.cwnd))
    dec_fired = ev.has_ack & slow & can_dec

    # loss (trim/timeout): halve once per RTT
    lost = _loss_event(ev)
    loss_dec = lost & ((now - s.last_dec) >= rtt)
    new_cwnd = jnp.where(loss_dec, new_cwnd * 0.5, new_cwnd)
    last_dec = jnp.where(dec_fired | loss_dec, now, s.last_dec)

    return s._replace(cwnd=jnp.clip(new_cwnd, p.mincwnd, p.maxcwnd), last_dec=last_dec)


def mprdma_update(p: CCParams, s: CCState, ev: CCEvent, now) -> CCState:
    """MPRDMA [40]: per-packet ECN (DCTCP-flavored): marked ACK -> cwnd -=
    mtu/2; unmarked -> +mtu per RTT.  No fairness shaping — the unfairness
    the paper observes for small messages emerges from exactly this rule."""
    now = jnp.asarray(now, jnp.float32)
    cwnd = jnp.maximum(s.cwnd, 1.0)
    inc = p.mtu * ev.ack_bytes / cwnd
    dec = 0.5 * ev.ack_bytes
    new_cwnd = jnp.where(ev.has_ack, jnp.where(ev.ecn, s.cwnd - dec, s.cwnd + inc), s.cwnd)

    lost = _loss_event(ev)
    can_dec = (now - s.last_dec) >= jnp.maximum(ev.rtt, p.brtt)
    loss_dec = lost & can_dec
    new_cwnd = jnp.where(loss_dec, new_cwnd * 0.5, new_cwnd)
    last_dec = jnp.where(loss_dec, now, s.last_dec)
    return s._replace(cwnd=jnp.clip(new_cwnd, p.mincwnd, p.maxcwnd), last_dec=last_dec)


def bbr_update(p: CCParams, s: CCState, ev: CCEvent, now) -> CCState:
    """BBR-lite [12]: windowed-max bottleneck-bandwidth estimate, 8-phase
    pacing-gain cycle, cwnd = cwnd_gain * BDP_est.  Captures BBR's defining
    slowness: rate converges only as the probe cycle advances (the paper
    observed ~7 RTTs)."""
    now = jnp.asarray(now, jnp.float32)
    rtprop = jnp.where(ev.has_ack, jnp.minimum(s.rtprop, ev.rtt), s.rtprop)
    delivered = s.win_delivered + jnp.where(ev.has_ack, ev.ack_bytes, 0.0)

    # close the estimation window every rtprop ticks
    boundary = now >= s.win_end
    win_len = jnp.maximum(rtprop, 1.0)
    sample = delivered / win_len
    # windowed max with decay — new samples take over within a few windows
    bw_est = jnp.where(boundary, jnp.maximum(sample, s.bw_est * 0.9), s.bw_est)
    delivered = jnp.where(boundary, 0.0, delivered)
    win_end = jnp.where(boundary, now + win_len, s.win_end)

    # pacing-gain cycle: probe, drain, cruise x6
    phase = (now / jnp.maximum(rtprop, 1.0)).astype(jnp.int32) % 8
    gain = jnp.where(phase == 0, p.bbr_probe_gain, jnp.where(phase == 1, p.bbr_drain_gain, 1.0))
    pacing_rate = bw_est * gain
    cwnd = p.bbr_cwnd_gain * bw_est * rtprop

    return s._replace(
        cwnd=jnp.clip(cwnd, p.mincwnd, p.maxcwnd),
        rtprop=rtprop,
        win_delivered=delivered,
        win_end=win_end,
        bw_est=bw_est,
        pacing_rate=pacing_rate,
    )


def eqds_update(p: CCParams, s: CCState, ev: CCEvent, now) -> CCState:
    """EQDS [46] (vanilla, receiver-driven): the *receiver* paces via pull
    credits (granted in the fabric model); the sender has no window logic —
    cwnd stays at the speculative cap and `credits` gate transmission."""
    credits = s.credits + ev.credit_grant
    return s._replace(credits=credits, cwnd=jnp.broadcast_to(p.maxcwnd, s.cwnd.shape))


def eqds_smartt_update(p: CCParams, s: CCState, ev: CCEvent, now) -> CCState:
    """Sec. 5.1: EQDS augmented with SMaRTT — receiver credits still pace,
    but the sender additionally runs the full SMaRTT window to cap its rate
    under fabric congestion."""
    from .smartt import smartt_update

    s = s._replace(credits=s.credits + ev.credit_grant)
    return smartt_update(p, s, ev, now)


def ecn_only_update(p: CCParams, s: CCState, ev: CCEvent, now) -> CCState:
    """Fig. 2/3 strawman: decrease by at most half an MTU per marked ACK,
    additive increase otherwise (paper: 'we decrease the congestion window
    by half an MTU per packet at most in response to ... ECN marking')."""
    cwnd = jnp.maximum(s.cwnd, 1.0)
    delta = jnp.where(ev.ecn, -0.5 * ev.ack_bytes, p.mtu * ev.ack_bytes / cwnd)
    new_cwnd = jnp.where(ev.has_ack, s.cwnd + delta, s.cwnd)
    lost = _loss_event(ev)
    new_cwnd = jnp.where(lost, new_cwnd - ev.trim_bytes - ev.to_bytes, new_cwnd)
    return s._replace(cwnd=jnp.clip(new_cwnd, p.mincwnd, p.maxcwnd))


def delay_only_update(p: CCParams, s: CCState, ev: CCEvent, now) -> CCState:
    """Fig. 2/3 strawman: same rule keyed on rtt > trtt instead of ECN."""
    cwnd = jnp.maximum(s.cwnd, 1.0)
    slow = ev.rtt > p.trtt
    delta = jnp.where(slow, -0.5 * ev.ack_bytes, p.mtu * ev.ack_bytes / cwnd)
    new_cwnd = jnp.where(ev.has_ack, s.cwnd + delta, s.cwnd)
    lost = _loss_event(ev)
    new_cwnd = jnp.where(lost, new_cwnd - ev.trim_bytes - ev.to_bytes, new_cwnd)
    return s._replace(cwnd=jnp.clip(new_cwnd, p.mincwnd, p.maxcwnd))
