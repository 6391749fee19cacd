"""Static-analysis layer of the port: an op auditor and an AST contract
linter (DESIGN.md Sec. 10), the counterpart of ``repro.analysis``.

Machine-checks the engine's invariants on the recorded PyTorch programs
of a tick — dtype compactness, convert churn, no host syncs inside a tick
phase, per-phase scatter/gather budgets, no aliased state leaves, the
sweepable/static split of ``SimConfig`` — plus source-level contracts
(kernel ref/kernel signature parity, seeded randomness, numpy-only Consts
building).  Run the whole battery with::

    python -m repro_torch.analysis                 # on the card
    python -m repro_torch.analysis --device cpu    # on the CPU

This ``__init__`` stays import-light on purpose: ``state`` and ``shard``
import :mod:`repro_torch.analysis.trace_guard` for their counters, so
pulling the auditor (which imports the netsim) in here would be a cycle.
Import ``repro_torch.analysis.audit`` / ``repro_torch.analysis.lint``
explicitly.
"""

from repro_torch.analysis.trace_guard import TraceCounter, counter, trace_guard

__all__ = ["TraceCounter", "counter", "trace_guard"]
