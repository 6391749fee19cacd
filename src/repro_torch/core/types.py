"""Shared congestion-control state/parameter containers.

All per-flow state is struct-of-arrays (one tensor per field, flow-major)
so the update rules vectorize across flows — the layout the
``kernels/cc_update`` CUDA kernel reads directly, one thread per flow.

The containers and their field order are the reference's
(``repro/core/types.py``), so a ``CCState`` converts leaf by leaf.  The
paper stresses SMaRTT's footprint: 19 B per flow + 28 B global (Sec.
3.2.5); ``SMARTT_FIELDS`` names the subset of the union state that the
paper's algorithm needs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

F32 = torch.float32
I32 = torch.int32

SMARTT_FIELDS = (
    "cwnd",
    "acked",
    "qa_end",
    "trigger_qa",
    "bytes_to_ignore",
    "bytes_ignored",
    "fi_count",
    "fi_active",
    "avg_wtd",
)


class CCParams(NamedTuple):
    """Algorithm constants (0-d tensors, or [F] for the per-flow ones).

    fi/mi arrive pre-multiplied by the bandwidth scaling factor
    gamma = bdp / reference_bdp (paper Sec. 3.5 "Scaling"); md arrives
    pre-doubled when trimming is disabled (Sec. 3.3).
    """

    mtu: torch.Tensor            # bytes
    bdp: torch.Tensor            # bytes (base, inter-rack)
    maxcwnd: torch.Tensor        # 1.25 * bdp
    mincwnd: torch.Tensor        # 1 MTU
    brtt: torch.Tensor           # ticks, per-flow [F] (hop-count specific)
    trtt: torch.Tensor           # ticks, per-flow [F] = 1.5 * brtt
    fd: torch.Tensor             # fair-decrease constant (0.8)
    md: torch.Tensor             # multiplicative-decrease constant (2; 4 w/o trim)
    fi: torch.Tensor             # fair-increase constant (0.25 * gamma)
    mi: torch.Tensor             # mult-increase constant (brtt/(trtt-brtt) * gamma)
    k_fast: torch.Tensor         # FastIncrease MTUs per ACK (2)
    qa_scaling: torch.Tensor     # 0.8
    wtd_alpha: torch.Tensor      # EWMA weight for Wait-to-Decrease
    wtd_thresh: torch.Tensor     # 0.25
    fi_rtt_tol: torch.Tensor     # "rtt ~= brtt" multiplier for FastIncrease
    react_every: torch.Tensor    # i32 CC reaction granularity in ACKs (Fig. 3b)
    # baseline parameters
    sw_ai: torch.Tensor          # swift additive increase (MTUs per RTT)
    sw_beta: torch.Tensor        # swift multiplicative-decrease slope
    sw_max_mdf: torch.Tensor     # swift max decrease factor per RTT
    bbr_probe_gain: torch.Tensor
    bbr_drain_gain: torch.Tensor
    bbr_cwnd_gain: torch.Tensor


class CCState(NamedTuple):
    """Per-flow congestion state (union across algorithms), tensors [F]."""

    cwnd: torch.Tensor           # f32 bytes
    # --- SMaRTT (Alg. 1-3) ---
    acked: torch.Tensor          # f32 bytes received in current trtt window
    qa_end: torch.Tensor         # f32 tick: end of current QuickAdapt window
    trigger_qa: torch.Tensor     # bool
    bytes_to_ignore: torch.Tensor  # f32
    bytes_ignored: torch.Tensor  # f32
    fi_count: torch.Tensor       # f32 FastIncrease byte counter
    fi_active: torch.Tensor      # bool
    avg_wtd: torch.Tensor        # f32 Wait-to-Decrease EWMA of ECN marks
    ack_count: torch.Tensor      # i32 ACK counter (reaction granularity, Fig. 3b)
    # --- Swift / MPRDMA ---
    last_dec: torch.Tensor       # f32 tick of last multiplicative decrease
    # --- BBR-lite ---
    bw_est: torch.Tensor         # f32 bytes/tick bottleneck estimate
    rtprop: torch.Tensor         # f32 min RTT seen
    win_delivered: torch.Tensor  # f32 bytes delivered in current estimation window
    win_end: torch.Tensor        # f32 tick
    pacing_rate: torch.Tensor    # f32 bytes/tick (0 = unpaced)
    # --- EQDS (receiver-credit) ---
    credits: torch.Tensor        # f32 bytes of unspent pull credit
    spec_budget: torch.Tensor    # f32 speculative first-window budget


class CCEvent(NamedTuple):
    """Per-flow control-plane events aggregated for one tick, tensors [F].

    The slotted fabric delivers at most one ACK per flow per tick (one
    delivery per receiver NIC per tick); trims/timeouts can batch.
    """

    has_ack: torch.Tensor        # bool
    ack_bytes: torch.Tensor      # f32 data bytes covered by the ACK (p.size)
    ecn: torch.Tensor            # bool echoed ECN mark
    rtt: torch.Tensor            # f32 ticks measured from echoed timestamp
    ack_entropy: torch.Tensor    # i32 echoed path entropy (for REPS)
    n_trims: torch.Tensor        # i32 trimmed-header notifications this tick
    trim_bytes: torch.Tensor     # f32 original data bytes those trims covered
    n_timeouts: torch.Tensor     # i32 retransmission timeouts fired this tick
    to_bytes: torch.Tensor       # f32 data bytes declared lost by timeout
    unacked: torch.Tensor        # f32 bytes currently in flight (transport view)
    credit_grant: torch.Tensor   # f32 bytes of receiver credit arriving (EQDS)


def init_cc_state(n_flows: int, params: CCParams, start_cwnd=None,
                  lead: tuple = ()) -> CCState:
    """Tick-0 CC state on the device the parameters live on; ``lead`` a
    lane batch's leading shape (the parameters then broadcast against
    ``lead + (n_flows,)``)."""
    dev = params.mtu.device
    shape = tuple(lead) + (n_flows,)
    f32 = lambda v: torch.full(shape, v, dtype=F32, device=dev)
    if start_cwnd is None:
        start_cwnd = params.maxcwnd
    return CCState(
        cwnd=torch.as_tensor(start_cwnd, dtype=F32, device=dev).expand(shape).clone(),
        acked=f32(0.0),
        qa_end=f32(0.0),
        trigger_qa=torch.zeros(shape, dtype=torch.bool, device=dev),
        bytes_to_ignore=f32(0.0),
        bytes_ignored=f32(0.0),
        fi_count=f32(0.0),
        fi_active=torch.zeros(shape, dtype=torch.bool, device=dev),
        avg_wtd=f32(0.0),
        ack_count=torch.zeros(shape, dtype=I32, device=dev),
        last_dec=f32(-1e9),
        bw_est=f32(0.0) + params.mtu,   # line rate: 1 MTU per tick
        rtprop=params.brtt.to(F32) * torch.ones(shape, dtype=F32, device=dev),
        win_delivered=f32(0.0),
        win_end=f32(0.0),
        pacing_rate=f32(0.0),
        credits=f32(0.0),
        spec_budget=params.bdp.to(F32).expand(shape).clone(),
    )


def make_cc_params(
    *,
    mtu: float,
    bdp: float,
    brtt,                      # scalar or per-flow [F] ticks
    device,
    target_mult: float = 1.5,  # trtt = 1.5 * brtt (paper Sec. 3)
    fd: float = 0.8,
    md: float = 2.0,
    fi: float = 0.25,
    k_fast: float = 2.0,
    qa_scaling: float = 0.8,
    wtd_alpha: float = 1.0 / 32.0,   # paper omits alpha; see DESIGN.md Sec. 2
    wtd_thresh: float = 0.25,
    fi_rtt_tol: float = 1.1,
    react_every: int = 1,
    gamma: float = 1.0,
    use_trimming: bool = True,
    maxcwnd_mult: float = 1.25,
    sw_ai: float = 1.0,
    sw_beta: float = 0.8,
    sw_max_mdf: float = 0.5,
) -> CCParams:
    a = lambda v: torch.tensor(v, dtype=F32, device=device)
    brtt = torch.as_tensor(brtt, dtype=F32).to(device)
    trtt = brtt * target_mult
    # mi chosen so the window grows by at most one MTU per RTT (Sec. 3.2.4):
    # mi = brtt / (trtt - brtt); with trtt = 1.5*brtt this is 2.
    mi = brtt / torch.maximum(trtt - brtt, a(1e-6))
    return CCParams(
        mtu=a(mtu),
        bdp=a(bdp),
        maxcwnd=a(maxcwnd_mult * bdp),
        mincwnd=a(mtu),
        brtt=brtt,
        trtt=trtt,
        fd=a(fd),
        md=a(md * (1.0 if use_trimming else 2.0)),  # double md w/o trimming (Sec. 3.3)
        fi=a(fi * gamma),
        mi=mi * a(gamma),
        k_fast=a(k_fast),
        qa_scaling=a(qa_scaling),
        wtd_alpha=a(wtd_alpha),
        wtd_thresh=a(wtd_thresh),
        fi_rtt_tol=a(fi_rtt_tol),
        react_every=torch.tensor(react_every, dtype=I32, device=device),
        sw_ai=a(sw_ai),
        sw_beta=a(sw_beta),
        sw_max_mdf=a(sw_max_mdf),
        bbr_probe_gain=a(1.25),
        bbr_drain_gain=a(0.75),
        bbr_cwnd_gain=a(2.0),
    )
