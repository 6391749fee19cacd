"""Backend dispatch for the fused departures phase.

``get(backend)`` resolves ``SimConfig.departures_backend`` to the callable
``fabric.departures`` runs the phase through:

  ``run(tick, lat, flags, operands) -> None`` (operands updated in place)

on a lane batch (``kernels/lanes``), with the contract of
``ref.departures_lanes_ref``.  ``"kernel"`` launches the
CUDA kernel for CUDA tensors and takes the plain version for CPU tensors;
``"plain"`` always takes the plain version, which is also the earlier
design (the phase in PyTorch, the RED flip inline).
"""

from __future__ import annotations

import functools

from repro_torch.kernels import build
from repro_torch.kernels.departures import kernel as K
from repro_torch.kernels.departures import ref as R

BACKENDS = ("kernel", "plain")


def departures(k, lat: R.Lat, fl: R.Flags, o: R.Operands, *,
               backend: str = "kernel") -> None:
    if build.use_kernel(backend, o.infl):
        return K.departures(k, lat, fl, o)
    return R.departures_lanes_ref(k, lat, fl, o)


def get(backend: str):
    """Resolve a departures backend name to the phase's callable."""
    if backend not in BACKENDS:
        raise KeyError(f"unknown departures backend {backend!r}; have {BACKENDS}")
    return functools.partial(departures, backend=backend)
