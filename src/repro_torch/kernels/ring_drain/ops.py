"""Dispatch for the sent-ring drain kernel: the drain callable of the
control phase's earlier design (``transport.control_split``, run by
``SimConfig.transport_backend="split"``):

  ``ring_drain(t, rto, started, has_ack, ack_seq, lbits, bitmap,
               sent0, sent1, sent2) -> (state', n_to, spur, unacked_pkts)``

with the contract of ``ref.ring_drain_ref``.  ``"kernel"`` launches the
CUDA kernel for CUDA tensors and takes the plain version for CPU tensors;
``"plain"`` always takes the plain version.
"""

from __future__ import annotations

from repro_torch.kernels import build
from repro_torch.kernels.ring_drain import kernel as K
from repro_torch.kernels.ring_drain import ref as R


def ring_drain(t, rto, started, has_ack, ack_seq, lbits, bitmap,
               sent0, sent1, sent2, *, backend: str = "kernel"):
    if build.use_kernel(backend, sent0):
        return K.ring_drain(t, rto, started, has_ack, ack_seq, lbits, bitmap,
                            sent0, sent1, sent2)
    return R.ring_drain_ref(t, rto, started, has_ack, ack_seq, lbits,
                            bitmap, sent0, sent1, sent2,
                            w=sent0.shape[1], ww=lbits.shape[1],
                            maxw=bitmap.shape[1])
