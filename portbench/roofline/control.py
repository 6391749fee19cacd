"""Bytes the fused control launch (``csrc/control.cu``) must move.

The arithmetic is ``chip_smoke.py``'s ``control_bytes`` (the bound of
PERF.md's table of kernels): each input read once and each output written
once, per live lane a launch (a lane that is not live returns at once).
Of its data-dependent terms, the ACKed and timed-out slots' sequence and
dedupe words are counted from the lanes' totals; the send ticks of live
ring slots are left out, so the count is a lower bound and the share
never overstates the kernel.  SMaRTT's update is a few operations a flow:
the launch is bound by bytes.
"""

from __future__ import annotations

KERNEL = "control_kernel"
I = 4


def lane_tick_bytes(s: dict) -> int:
    """Bytes of one live lane's launch that do not depend on the data."""
    nf, w, n = s["NF"], s["W"], s["N"]
    out = 2 * n * 6 * I                                     # ACK slot: read, zeroed
    out += nf * (4 * I + 1)                                 # dst size t_start rto done
    out += 2 * nf * w * I                                   # sent state plane r/w
    if s["trimming"]:
        out += (2 * nf + 1) * (2 + s["WW"]) * I             # trim slot r/w
    if s["credit_based"]:
        out += (2 * nf + 1) * I
    if s["rto_backoff_max"]:
        out += 2 * nf * I
    out += nf * I                                           # unacked
    out += nf * (9 * I + 2)                                 # the event buffer
    out += 2 * nf * 34 + 3 * nf * I                         # SMaRTT planes r/w, brtt trtt mi
    out += 2 * (64 + 3) * I                                 # the counters
    return out


def study_bytes(s: dict, lane_ticks: int, rows: list) -> tuple:
    """``(bytes, f32 operations)`` of a study's launches: ``lane_ticks``
    live lane-ticks (the lanes' executed ticks summed), ``rows`` the
    lanes' result rows (ACKs and timeouts)."""
    data = sum((r["acks"] + r["timeouts"]) * 2 * I for r in rows)
    return lane_tick_bytes(s) * lane_ticks + data, 0.0
