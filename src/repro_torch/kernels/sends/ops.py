"""Backend dispatch for the fused sends phase.

``get(backend)`` resolves ``SimConfig.sender_backend`` to the callable
``sender.sends`` runs the phase through:

  ``run(tick, lat_send, flags, operands) -> None`` (operands updated in
  place)

on a lane batch (``kernels/lanes``), with the contract of
``ref.sends_lanes_ref``.  ``"kernel"`` launches the CUDA
kernel for CUDA tensors and takes the plain version for CPU tensors;
``"plain"`` always takes the plain version; ``"split"`` is the earlier
design, ``sends_ref``'s PyTorch with the ``rr_pick`` kernel in it (its
plain version on CPU tensors).  ``grant_pick(backend)`` is the EQDS grant
phase's ``rr_pick`` under the same backend: the kernel but for
``"plain"``.
"""

from __future__ import annotations

import functools

from repro_torch.kernels import build
from repro_torch.kernels.enqueue_arb import ops as enqueue_arb_ops
from repro_torch.kernels.sends import kernel as K
from repro_torch.kernels.sends import ref as R

BACKENDS = ("kernel", "plain", "split")


def sends(k, lat_send: int, fl: R.Flags, o: R.Operands, *, backend: str = "kernel"):
    if build.use_kernel(backend, o.infl):
        return K.sends(k, lat_send, fl, o)
    return R.sends_lanes_ref(k, lat_send, fl, o)


def _check(backend: str) -> None:
    if backend not in BACKENDS:
        raise KeyError(f"unknown sender backend {backend!r}; have {BACKENDS}")


def get(backend: str):
    """Resolve a sender backend name to the sends phase's callable."""
    _check(backend)
    if backend == "split":
        return functools.partial(R.sends_lanes_ref, arb=grant_pick("kernel"))
    return functools.partial(sends, backend=backend)


def grant_pick(backend: str):
    """The EQDS grant phase's round-robin pick under a sender backend."""
    _check(backend)
    return functools.partial(enqueue_arb_ops.rr_pick,
                             backend="plain" if backend == "plain" else "kernel")
