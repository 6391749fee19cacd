"""Dispatch table: (algorithm name, backend) -> per-tick CC update function.

The algorithm *and backend* choice is static at trace time (each owns its
jit specialization); all numeric parameters stay traced so tuning never
recompiles.

Backends:
  ``jnp``    — the pure-jnp reference update (every algorithm).
  ``pallas`` — the blocked ``kernels/cc_update`` Pallas kernel streaming
               the flow table through VMEM tiles (SMaRTT only; interpret
               mode off-TPU, so it runs — and bit-matches the jnp backend —
               everywhere).
"""

from __future__ import annotations

from . import baselines
from .smartt import smartt_update

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

BACKENDS = ("jnp",)


def get(name: str, cc_backend: str = "jnp"):
    if name not in ALGORITHMS:
        raise KeyError(f"unknown CC algorithm {name!r}; have {sorted(ALGORITHMS)}")
    if cc_backend == "jnp":
        return ALGORITHMS[name]
    raise KeyError(f"unknown cc backend {cc_backend!r}; have {BACKENDS}")
