"""Baseline congestion-control algorithms the paper compares against
(Sec. 4): Swift, MPRDMA, BBR, EQDS — plus the single-signal strawmen of
Fig. 2/3 (ECN-only, delay-only) and the EQDS+SMaRTT hybrid of Sec. 5.1.

Compact re-implementations, as in the reference
(``repro/core/baselines.py``; simplifications in DESIGN.md Sec. 2): each
keeps the property the paper leans on — Swift's once-per-RTT delay MD,
MPRDMA's per-packet ECN reaction and its unfairness, BBR's slow
bandwidth-probe convergence, EQDS's receiver-credit pacing with no fabric
CC.

The expression order is the reference's, operation for operation, and
every operand the tick enters is a tensor: ``now`` is filled into an
[F] plane (``_now_plane``), because PyTorch computes ``scalar / tensor``
as ``reciprocal(tensor) * scalar``, which is not the IEEE quotient.
None of these updates has a multiply feeding an add that XLA:CPU could
contract differently (MPRDMA's ``cwnd - 0.5 * ack_bytes`` and the credit
spends scale by a power of two or by 0/1, which a fused multiply-add
rounds the same).
"""

from __future__ import annotations

import torch

from repro_torch.core.types import CCEvent, CCParams, CCState

F32 = torch.float32


def _now_plane(now, like: torch.Tensor) -> torch.Tensor:
    """The tick as an f32 [F] plane, or [L, F] for a lane batch's ticks
    (an i32 ``[L, 1]`` column); exact below 2**24, which every tick budget
    is; a fill or a broadcast, not a host-to-device copy."""
    if isinstance(now, torch.Tensor):
        return now.to(F32).expand(like.shape)
    return torch.full_like(like, float(now), dtype=F32)


def _clip_cwnd(p: CCParams, cwnd):
    return torch.minimum(torch.maximum(cwnd, p.mincwnd), p.maxcwnd)


def _loss_event(ev: CCEvent):
    return (ev.n_trims + ev.n_timeouts) > 0


def swift_update(p: CCParams, s: CCState, ev: CCEvent, now) -> CCState:
    """Swift: delay-based AIMD with per-RTT multiplicative decrease.

    target delay = trtt; additive increase sw_ai MTU per RTT; decrease
    factor 1 - beta*(rtt-t)/rtt clamped to sw_max_mdf, at most once per
    RTT; a trim or timeout halves the window once per RTT."""
    now = _now_plane(now, s.cwnd)
    rtt = ev.rtt.clamp_min(1e-6)
    cwnd = s.cwnd.clamp_min(1.0)
    can_dec = (now - s.last_dec) >= rtt

    inc = p.sw_ai * p.mtu * ev.ack_bytes / cwnd
    mdf = torch.maximum(1.0 - p.sw_beta * (rtt - p.trtt) / rtt, 1.0 - p.sw_max_mdf)

    slow = ev.rtt > p.trtt
    new_cwnd = torch.where(
        ev.has_ack & ~slow, s.cwnd + inc,
        torch.where(ev.has_ack & slow & can_dec, s.cwnd * mdf, s.cwnd))
    dec_fired = ev.has_ack & slow & can_dec

    lost = _loss_event(ev)
    loss_dec = lost & ((now - s.last_dec) >= rtt)
    new_cwnd = torch.where(loss_dec, new_cwnd * 0.5, new_cwnd)
    last_dec = torch.where(dec_fired | loss_dec, now, s.last_dec)
    return s._replace(cwnd=_clip_cwnd(p, new_cwnd), last_dec=last_dec)


def mprdma_update(p: CCParams, s: CCState, ev: CCEvent, now) -> CCState:
    """MPRDMA: per-packet ECN (DCTCP-flavored): a marked ACK takes half
    its bytes off the window, an unmarked one adds an MTU per RTT.  No
    fairness shaping."""
    now = _now_plane(now, s.cwnd)
    cwnd = s.cwnd.clamp_min(1.0)
    inc = p.mtu * ev.ack_bytes / cwnd
    dec = 0.5 * ev.ack_bytes
    new_cwnd = torch.where(ev.has_ack, torch.where(ev.ecn, s.cwnd - dec, s.cwnd + inc),
                           s.cwnd)

    lost = _loss_event(ev)
    can_dec = (now - s.last_dec) >= torch.maximum(ev.rtt, p.brtt)
    loss_dec = lost & can_dec
    new_cwnd = torch.where(loss_dec, new_cwnd * 0.5, new_cwnd)
    last_dec = torch.where(loss_dec, now, s.last_dec)
    return s._replace(cwnd=_clip_cwnd(p, new_cwnd), last_dec=last_dec)


def bbr_update(p: CCParams, s: CCState, ev: CCEvent, now) -> CCState:
    """BBR-lite: windowed-max bottleneck-bandwidth estimate, 8-phase
    pacing-gain cycle, cwnd = cwnd_gain * BDP_est — rate converges only as
    the probe cycle advances."""
    now = _now_plane(now, s.cwnd)
    rtprop = torch.where(ev.has_ack, torch.minimum(s.rtprop, ev.rtt), s.rtprop)
    delivered = s.win_delivered + torch.where(ev.has_ack, ev.ack_bytes, 0.0)

    # close the estimation window every rtprop ticks
    boundary = now >= s.win_end
    win_len = rtprop.clamp_min(1.0)
    sample = delivered / win_len
    # windowed max with decay — new samples take over within a few windows
    bw_est = torch.where(boundary, torch.maximum(sample, s.bw_est * 0.9), s.bw_est)
    delivered = torch.where(boundary, 0.0, delivered)
    win_end = torch.where(boundary, now + win_len, s.win_end)

    # pacing-gain cycle: probe, drain, cruise x6 (f32 -> i32 truncates
    # toward zero, as astype does)
    phase = torch.remainder((now / rtprop.clamp_min(1.0)).to(torch.int32), 8)
    gain = torch.where(phase == 0, p.bbr_probe_gain,
                       torch.where(phase == 1, p.bbr_drain_gain, 1.0))
    pacing_rate = bw_est * gain
    cwnd = p.bbr_cwnd_gain * bw_est * rtprop

    return s._replace(
        cwnd=_clip_cwnd(p, cwnd),
        rtprop=rtprop,
        win_delivered=delivered,
        win_end=win_end,
        bw_est=bw_est,
        pacing_rate=pacing_rate,
    )


def eqds_update(p: CCParams, s: CCState, ev: CCEvent, now) -> CCState:
    """EQDS (vanilla, receiver-driven): the receiver paces via pull
    credits (``sender.grants``); the sender has no window logic — cwnd
    stays at the speculative cap and ``credits`` gate transmission."""
    return s._replace(credits=s.credits + ev.credit_grant,
                      cwnd=p.maxcwnd.expand(s.cwnd.shape).clone())


def eqds_smartt_update(p: CCParams, s: CCState, ev: CCEvent, now) -> CCState:
    """Sec. 5.1: EQDS augmented with SMaRTT — receiver credits still pace,
    but the sender also runs the full SMaRTT window to cap its rate under
    fabric congestion."""
    from repro_torch.core.smartt import smartt_update

    s = s._replace(credits=s.credits + ev.credit_grant)
    return smartt_update(p, s, ev, now)


def ecn_only_update(p: CCParams, s: CCState, ev: CCEvent, now) -> CCState:
    """Fig. 2/3 strawman: decrease by at most half an MTU per marked ACK,
    additive increase otherwise; losses take their bytes off."""
    cwnd = s.cwnd.clamp_min(1.0)
    delta = torch.where(ev.ecn, -0.5 * ev.ack_bytes, p.mtu * ev.ack_bytes / cwnd)
    new_cwnd = torch.where(ev.has_ack, s.cwnd + delta, s.cwnd)
    lost = _loss_event(ev)
    new_cwnd = torch.where(lost, new_cwnd - ev.trim_bytes - ev.to_bytes, new_cwnd)
    return s._replace(cwnd=_clip_cwnd(p, new_cwnd))


def delay_only_update(p: CCParams, s: CCState, ev: CCEvent, now) -> CCState:
    """Fig. 2/3 strawman: the ECN-only rule keyed on rtt > trtt."""
    cwnd = s.cwnd.clamp_min(1.0)
    slow = ev.rtt > p.trtt
    delta = torch.where(slow, -0.5 * ev.ack_bytes, p.mtu * ev.ack_bytes / cwnd)
    new_cwnd = torch.where(ev.has_ack, s.cwnd + delta, s.cwnd)
    lost = _loss_event(ev)
    new_cwnd = torch.where(lost, new_cwnd - ev.trim_bytes - ev.to_bytes, new_cwnd)
    return s._replace(cwnd=_clip_cwnd(p, new_cwnd))
