"""Bytes the fused sends launch (``csrc/sends.cu``) must move.

The arithmetic is ``chip_smoke.py``'s ``sends_bytes`` (the bound of
PERF.md's table of kernels), per live lane a launch: every sender's row
of ``flows_of`` and cursor, every flow's start tick and done flag, and
for each packet a NIC emits, its flow's ring state plane (the
retransmission scan), sequence, size, unacked and window, its resent
sequence, first-hop tables and LB words, and the NIC row, sent-ring word
and sequence it writes.  Packets emitted are counted from the lanes'
totals (each flow's packets once, and every retransmission); flows that
pass activation but do not emit, and cursors that move, are left out, so
the count is a lower bound and the share never overstates the kernel.
"""

from __future__ import annotations

KERNEL = "sends_kernel"
I = 4


def lane_tick_bytes(s: dict) -> int:
    """Bytes of one live lane's launch that do not depend on the data."""
    return (s["N"] * s["FMAX"] + s["N"]) * I + s["NF"] * (I + 1) + s["NF"] * s["D"] * 3 * I


def emit_bytes(s: dict) -> int:
    """Bytes of one emitted packet: its flow's scan and words (read), its
    NIC row of 7 words, ring word and sequence (written)."""
    return (s["W"] + 4) * I + 8 * I + 9 + 7 * I + 2 * I


def study_bytes(s: dict, lane_ticks: int, rows: list) -> tuple:
    """``(bytes, f32 operations)`` of a study's launches: ``lane_ticks``
    live lane-ticks, ``rows`` the lanes' result rows with each lane's
    packets to send (``packets``) and retransmissions (``retx``)."""
    emits = sum(r["packets"] + r["retx"] for r in rows)
    return lane_tick_bytes(s) * lane_ticks + emits * emit_bytes(s), 0.0
