"""Backend dispatch for the sent-ring drain kernel.

``get(backend)`` resolves ``SimConfig.transport_backend`` to the drain
callable ``transport.control`` folds its ACK/trim/timeout events through:

  ``drain(t, rto, started, has_ack, ack_seq, lbits, bitmap,
          sent0, sent1, sent2) -> (state', n_to, spur, unacked_pkts)``

with the contract of ``ref.ring_drain_ref``.  ``"kernel"`` launches the
CUDA kernel for CUDA tensors and takes the plain version for CPU tensors;
``"plain"`` always takes the plain version.
"""

from __future__ import annotations

import functools

from repro_torch.kernels import build
from repro_torch.kernels.ring_drain import kernel as K
from repro_torch.kernels.ring_drain import ref as R

BACKENDS = ("kernel", "plain")


def ring_drain(t, rto, started, has_ack, ack_seq, lbits, bitmap,
               sent0, sent1, sent2, *, backend: str = "kernel"):
    if build.use_kernel(backend, sent0):
        return K.ring_drain(t, rto, started, has_ack, ack_seq, lbits, bitmap,
                            sent0, sent1, sent2)
    return R.ring_drain_ref(t, rto, started, has_ack, ack_seq, lbits,
                            bitmap, sent0, sent1, sent2,
                            w=sent0.shape[1], ww=lbits.shape[1],
                            maxw=bitmap.shape[1])


def get(backend: str):
    """Resolve a transport backend name to the drain callable."""
    if backend not in BACKENDS:
        raise KeyError(
            f"unknown transport backend {backend!r}; have {BACKENDS}")
    return functools.partial(ring_drain, backend=backend)
