"""Dispatch for the red_mark kernel: the entry point of the switch
datapath's RED marking and trim admission (the reference's
``repro/kernels/red_mark/ops.py`` ``red_mark_op``).

A CUDA ``q_size`` launches the hand-written kernel (or raises); a CPU one
takes the plain version — the only reason the plain version is taken is
that the tensors lie on the CPU.  ``backend="plain"`` always takes it.

The simulator's ``fabric.departures`` computes the same coin flip inline,
as the reference's does (``fabric.red_marks``); ``chip_smoke.py`` holds
this kernel's marks to that flip on a stretch of ``perm_1024n_3t``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.red_mark import kernel as K
from repro_torch.kernels.red_mark import ref as R


def red_mark_op(q_size, arrivals, *, cap: int, kmin, kmax, tick, salt=0xECD,
                backend: str = "kernel"):
    """``(mark, admit, trim)`` for ``[Q]`` i32 queues (the plain version
    also takes leading dimensions, ``[..., Q]``)."""
    q_size = q_size.to(torch.int32)
    arrivals = arrivals.to(torch.int32)
    if build.use_kernel(backend, q_size):
        return K.red_mark(q_size, arrivals, cap=cap, kmin=kmin, kmax=kmax,
                          tick=tick, salt=salt)
    return R.red_mark_ref(q_size, arrivals, cap, kmin, kmax, tick, salt)
