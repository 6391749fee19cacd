"""Shared congestion-control state/parameter containers.

All per-flow state is struct-of-arrays (one array per field, flow-major) so
the update rules vectorize across flows — on TPU this is the layout the
``kernels/cc_update`` Pallas kernel consumes directly.

The paper stresses SMaRTT's footprint: 19 B per flow + 28 B global (Sec.
3.2.5).  Our unified ``CCState`` carries the union of all algorithms' fields
for engine simplicity; `SMARTT_FIELDS` documents the subset the paper's
algorithm actually needs (which matches the 19-byte budget).
"""

from __future__ import annotations

from typing import NamedTuple

from . import np32 as jnp

# Fields required by SMaRTT itself (paper Sec. 3.2.5 memory budget):
#   cwnd(4) acked(4) qa_end(4) bytes_to_ignore(4) bytes_ignored(~2)
#   fi_count(~2) avg_wtd(1) trigger_qa/fi_active(bits)  ~= 19 B/flow.
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
    """Algorithm constants (traced scalars — retuning never recompiles).

    fi/mi arrive pre-multiplied by the bandwidth scaling factor
    gamma = bdp / reference_bdp (paper Sec. 3.5 "Scaling"); md arrives
    pre-doubled when trimming is disabled (Sec. 3.3).
    """

    mtu: jnp.ndarray            # bytes
    bdp: jnp.ndarray            # bytes (base, inter-rack)
    maxcwnd: jnp.ndarray        # 1.25 * bdp
    mincwnd: jnp.ndarray        # 1 MTU
    brtt: jnp.ndarray           # ticks, per-flow [F] (hop-count specific)
    trtt: jnp.ndarray           # ticks, per-flow [F] = 1.5 * brtt
    fd: jnp.ndarray             # fair-decrease constant (0.8)
    md: jnp.ndarray             # multiplicative-decrease constant (2; 4 w/o trim)
    fi: jnp.ndarray             # fair-increase constant (0.25 * gamma)
    mi: jnp.ndarray             # mult-increase constant (brtt/(trtt-brtt) * gamma)
    k_fast: jnp.ndarray         # FastIncrease MTUs per ACK (2)
    qa_scaling: jnp.ndarray     # 0.8
    wtd_alpha: jnp.ndarray      # EWMA weight for Wait-to-Decrease
    wtd_thresh: jnp.ndarray     # 0.25
    fi_rtt_tol: jnp.ndarray     # "rtt ~= brtt" multiplier for FastIncrease
    react_every: jnp.ndarray    # CC reaction granularity in ACKs (Fig. 3b), 1 = per packet
    # baseline parameters
    sw_ai: jnp.ndarray          # swift additive increase (MTUs per RTT)
    sw_beta: jnp.ndarray        # swift multiplicative-decrease slope
    sw_max_mdf: jnp.ndarray     # swift max decrease factor per RTT
    bbr_probe_gain: jnp.ndarray
    bbr_drain_gain: jnp.ndarray
    bbr_cwnd_gain: jnp.ndarray


class CCState(NamedTuple):
    """Per-flow congestion state (union across algorithms), arrays [F]."""

    cwnd: jnp.ndarray           # f32 bytes
    # --- SMaRTT (Alg. 1-3) ---
    acked: jnp.ndarray          # f32 bytes received in current trtt window
    qa_end: jnp.ndarray         # f32 tick: end of current QuickAdapt window
    trigger_qa: jnp.ndarray     # bool
    bytes_to_ignore: jnp.ndarray  # f32
    bytes_ignored: jnp.ndarray  # f32
    fi_count: jnp.ndarray       # f32 FastIncrease byte counter
    fi_active: jnp.ndarray      # bool
    avg_wtd: jnp.ndarray        # f32 Wait-to-Decrease EWMA of ECN marks
    ack_count: jnp.ndarray      # i32 ACK counter (reaction granularity, Fig. 3b)
    # --- Swift / MPRDMA ---
    last_dec: jnp.ndarray       # f32 tick of last multiplicative decrease
    # --- BBR-lite ---
    bw_est: jnp.ndarray         # f32 bytes/tick bottleneck estimate
    rtprop: jnp.ndarray         # f32 min RTT seen
    win_delivered: jnp.ndarray  # f32 bytes delivered in current estimation window
    win_end: jnp.ndarray        # f32 tick
    pacing_rate: jnp.ndarray    # f32 bytes/tick (0 = unpaced)
    # --- EQDS (receiver-credit) ---
    credits: jnp.ndarray        # f32 bytes of unspent pull credit
    spec_budget: jnp.ndarray    # f32 speculative first-window budget


class CCEvent(NamedTuple):
    """Per-flow control-plane events aggregated for one tick, arrays [F].

    The slotted fabric delivers at most one ACK per flow per tick (one
    delivery per receiver NIC per tick); trims/timeouts can batch.
    """

    has_ack: jnp.ndarray        # bool
    ack_bytes: jnp.ndarray      # f32 data bytes covered by the ACK (p.size)
    ecn: jnp.ndarray            # bool echoed ECN mark
    rtt: jnp.ndarray            # f32 ticks measured from echoed timestamp
    ack_entropy: jnp.ndarray    # i32 echoed path entropy (for REPS)
    n_trims: jnp.ndarray        # i32 trimmed-header notifications this tick
    trim_bytes: jnp.ndarray     # f32 original data bytes those trims covered
    n_timeouts: jnp.ndarray     # i32 retransmission timeouts fired this tick
    to_bytes: jnp.ndarray       # f32 data bytes declared lost by timeout
    unacked: jnp.ndarray        # f32 bytes currently in flight (transport view)
    credit_grant: jnp.ndarray   # f32 bytes of receiver credit arriving (EQDS)


def init_cc_state(n_flows: int, params: CCParams, start_cwnd=None) -> CCState:
    f32 = lambda v: jnp.full((n_flows,), v, jnp.float32)
    if start_cwnd is None:
        start_cwnd = params.maxcwnd
    return CCState(
        cwnd=jnp.broadcast_to(jnp.asarray(start_cwnd, jnp.float32), (n_flows,)).astype(jnp.float32),
        acked=f32(0.0),
        qa_end=f32(0.0),
        trigger_qa=jnp.zeros((n_flows,), bool),
        bytes_to_ignore=f32(0.0),
        bytes_ignored=f32(0.0),
        fi_count=f32(0.0),
        fi_active=jnp.zeros((n_flows,), bool),
        avg_wtd=f32(0.0),
        ack_count=jnp.zeros((n_flows,), jnp.int32),
        last_dec=f32(-1e9),
        bw_est=f32(0.0) + params.mtu,   # line rate: 1 MTU per tick
        rtprop=jnp.asarray(params.brtt, jnp.float32) * jnp.ones((n_flows,), jnp.float32),
        win_delivered=f32(0.0),
        win_end=f32(0.0),
        pacing_rate=f32(0.0),
        credits=f32(0.0),
        spec_budget=jnp.broadcast_to(jnp.asarray(params.bdp, jnp.float32), (n_flows,)).astype(jnp.float32),
    )


def make_cc_params(
    *,
    mtu: float,
    bdp: float,
    brtt,                      # scalar or per-flow [F] ticks
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
    brtt = jnp.asarray(brtt, jnp.float32)
    trtt = brtt * target_mult
    # mi chosen so the window grows by at most one MTU per RTT (Sec. 3.2.4):
    # mi = brtt / (trtt - brtt); with trtt = 1.5*brtt this is 2.
    mi = brtt / jnp.maximum(trtt - brtt, 1e-6)
    a = lambda v: jnp.asarray(v, jnp.float32)
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
        react_every=jnp.asarray(react_every, jnp.int32),
        sw_ai=a(sw_ai),
        sw_beta=a(sw_beta),
        sw_max_mdf=a(sw_max_mdf),
        bbr_probe_gain=a(1.25),
        bbr_drain_gain=a(0.75),
        bbr_cwnd_gain=a(2.0),
    )
