"""Backend dispatch for the fused control phase.

``get(backend)`` resolves ``SimConfig.transport_backend`` to the callable
``transport.control`` runs the phase's per-flow work through:

  ``run(tick, flags, operands) -> CCEvent`` (``[L, NF]`` views of one
  event buffer)

on a lane batch (``kernels/lanes``), with the contract of
``ref.control_lanes_ref``.  ``"kernel"`` launches the CUDA
kernel for CUDA tensors and takes the plain version for CPU tensors;
``"plain"`` always takes the plain version.  (``"split"``, the
``ring_drain`` and ``cc_update`` kernels with the PyTorch glue around
them, is ``transport.control_split``.)
"""

from __future__ import annotations

import functools

from repro_torch.kernels import build
from repro_torch.kernels.control import kernel as K
from repro_torch.kernels.control import ref as R

BACKENDS = ("kernel", "plain")


def control(k, fl: R.Flags, o: R.Operands, *, backend: str = "kernel"):
    if build.use_kernel(backend, o.sent):
        return K.control(k, fl, o)
    return R.control_lanes_ref(k, fl, o)


def get(backend: str):
    """Resolve a transport backend name to the phase's callable."""
    if backend not in BACKENDS:
        raise KeyError(f"unknown transport backend {backend!r}; have "
                       f"{BACKENDS + ('split',)}")
    return functools.partial(control, backend=backend)
