"""Backend dispatch for the fused arrivals phase.

``get(backend)`` resolves ``SimConfig.fabric_backend`` to the callable
``fabric.arrivals`` runs the phase through:

  ``run(tick, trim_delay, flags, operands, gbin) -> None`` (operands
  updated in place)

on a lane batch (``kernels/lanes``), with the contract of
``ref.arrivals_lanes_ref``.  ``"kernel"`` launches the CUDA
kernel for CUDA tensors and takes the plain version for CPU tensors;
``"plain"`` always takes the plain version; ``"split"`` is the earlier
design, ``arrivals_ref``'s PyTorch with the ``enqueue_rank`` kernel in
it (its plain version on CPU tensors).
"""

from __future__ import annotations

import functools

from repro_torch.kernels import build
from repro_torch.kernels.arrivals import kernel as K
from repro_torch.kernels.arrivals import ref as R
from repro_torch.kernels.enqueue_arb import ops as enqueue_arb_ops

BACKENDS = ("kernel", "plain", "split")


def arrivals(k, trim_delay: int, fl: R.Flags, o: R.Operands, gbin, *,
             backend: str = "kernel"):
    if build.use_kernel(backend, o.infl):
        return K.arrivals(k, trim_delay, fl, o, gbin)
    return R.arrivals_lanes_ref(k, trim_delay, fl, o, gbin)


def get(backend: str):
    """Resolve a fabric backend name to the phase's callable."""
    if backend not in BACKENDS:
        raise KeyError(f"unknown fabric backend {backend!r}; have {BACKENDS}")
    if backend == "split":
        return functools.partial(R.arrivals_lanes_ref, enqueue=functools.partial(
            enqueue_arb_ops.enqueue_rank, backend="kernel"))
    return functools.partial(arrivals, backend=backend)
