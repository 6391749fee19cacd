"""Dispatch table: (algorithm name, backend) -> per-tick CC update function.

Backends:
  ``kernel`` — the hand-written CUDA ``kernels/cc_update`` kernel for a
               CUDA state and its plain version for a CPU state (that is
               how the CPU tests run).  The default.  Only SMaRTT has a
               kernel, as in the reference (whose Pallas backend covers
               SMaRTT alone); for every other algorithm ``kernel`` runs
               its plain update on any device.
  ``plain``  — the plain PyTorch update on any device (the card's
               reference run compares the kernel against it).
"""

from __future__ import annotations

from repro_torch.core import baselines
from repro_torch.core.smartt import smartt_update

ALGORITHMS = {
    "smartt": smartt_update,
    "swift": baselines.swift_update,
    "mprdma": baselines.mprdma_update,
    "bbr": baselines.bbr_update,
    "eqds": baselines.eqds_update,
    "eqds_smartt": baselines.eqds_smartt_update,
    "ecn_only": baselines.ecn_only_update,
    "delay_only": baselines.delay_only_update,
}

# algorithms whose transmission is gated by receiver credits
CREDIT_BASED = {"eqds", "eqds_smartt"}
# algorithms that pace by rate rather than window alone
PACED = {"bbr"}

BACKENDS = ("kernel", "plain")


def _smartt_kernel_update(p, s, ev, now):
    from repro_torch.kernels.cc_update.ops import smartt_update_kernel

    return smartt_update_kernel(p, s, ev, now)


KERNEL_ALGORITHMS = {
    "smartt": _smartt_kernel_update,
}


def get(name: str, cc_backend: str = "kernel"):
    if name not in ALGORITHMS:
        raise KeyError(f"unknown CC algorithm {name!r}; have {sorted(ALGORITHMS)}")
    if cc_backend == "plain":
        return ALGORITHMS[name]
    if cc_backend == "kernel":
        return KERNEL_ALGORITHMS.get(name, ALGORITHMS[name])
    raise KeyError(f"unknown cc backend {cc_backend!r}; have {BACKENDS}")
