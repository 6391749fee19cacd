"""The card's peaks and a kernel's share of its roofline.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W power limit): 3.35 TB/s of HBM3, 67 TFLOP/s of float32 outside
the tensor cores.  Each ``<kernel>.py`` beside this file counts the bytes
and operations one traced study's launches of that kernel must move and
compute, from the run's shapes and what its lanes did; the share is the
least time those could take over the time the launches took.
"""

from __future__ import annotations

import importlib

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def bound_s(nbytes: float, f32_flops: float = 0.0) -> float:
    """The least time the card could take: bytes at the memory rate or
    operations at the float32 rate, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, f32_flops / F32_FLOPS_PER_S)


def share(nbytes: float, f32_flops: float, device_s: float):
    """Percent of the roofline the launches reached (``None`` without
    device time to compare)."""
    if device_s <= 0:
        return None
    return 100.0 * bound_s(nbytes, f32_flops) / device_s


def kernel_share(run, kernel: str):
    """Percent of the roofline that ``kernel``'s launches in the traced
    study reached: the bytes ``roofline/<kernel>.py`` counts for the
    study's live lane-ticks over the launches' device time (``None``
    without a trace or without a launch of it)."""
    if run.trace is None or run.shapes is None:
        return None
    mod = importlib.import_module(f"portbench.roofline.{kernel}")
    device_ns = sum(d for n, _, d in run.trace["ops"] if mod.KERNEL in n.split("(", 1)[0])
    if device_ns <= 0:
        return None
    lane_ticks = sum(run.trace["study"]["steps"])
    nbytes, flops = mod.study_bytes(run.shapes, lane_ticks, run.trace["rows"])
    return share(nbytes, flops, device_ns / 1e9)
