"""Dispatch table: (algorithm name, backend) -> per-tick CC update function.

Backends:
  ``kernel`` — the hand-written CUDA ``kernels/cc_update`` kernel for a
               CUDA state; the plain version for a CPU state (that is how
               the CPU tests run).  The default.
  ``plain``  — the plain PyTorch update on any device (the card's
               reference run compares the kernel against it).

Only SMaRTT is ported so far.  The reference's baselines are listed so
that asking for one fails with a ``KeyError`` that names what is missing
instead of silently running something else.
"""

from __future__ import annotations

from repro_torch.core.smartt import smartt_update

ALGORITHMS = {
    "smartt": smartt_update,
}

# the reference's other algorithms, still to be ported
UNPORTED = ("swift", "mprdma", "bbr", "eqds", "eqds_smartt", "ecn_only",
            "delay_only")

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
    if name in UNPORTED:
        raise KeyError(
            f"CC algorithm {name!r} is not ported to repro_torch yet; "
            f"ported: {sorted(ALGORITHMS)}")
    if name not in ALGORITHMS:
        raise KeyError(f"unknown CC algorithm {name!r}; have {sorted(ALGORITHMS)}")
    if cc_backend == "plain":
        return ALGORITHMS[name]
    if cc_backend == "kernel":
        return KERNEL_ALGORITHMS[name]
    raise KeyError(f"unknown cc backend {cc_backend!r}; have {BACKENDS}")
