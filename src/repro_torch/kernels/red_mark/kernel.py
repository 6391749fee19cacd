"""ctypes wrapper of the CUDA ``red_mark`` kernel (``csrc/red_mark.cu``).

Checks its operands (device, dtype, shape [Q], contiguity), allocates the
outputs, launches on PyTorch's current stream, raises if the launch
failed, and counts its launches in ``red_mark.launches``.  The five
scalars go by value: ``kmin`` and ``kmax`` as f32, ``cap``, ``tick`` and
``salt`` as i32 (a 0-d tensor among them is read to the host, one device
read a call).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _fn():
    fn = build.library().repro_red_mark
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _F, _F, _I, _I, _P]
    fn.restype = ctypes.c_int
    return fn


def _i32(x) -> int:
    """An i32 scalar's value (two's-complement wrap, as the reference's
    ``astype(int32)``)."""
    return int(np.int64(int(x)).astype(np.int32))


def red_mark(q_size, arrivals, *, cap, kmin, kmax, tick, salt):
    """RED mark / admit / trim over ``[Q]`` i32 queues; returns bool /
    i32 / i32 ``[Q]``."""
    dev = q_size.device
    (q,) = q_size.shape
    p_q = build.require(q_size, "q_size", torch.int32, (q,), dev)
    p_a = build.require(arrivals, "arrivals", torch.int32, (q,), dev)
    build.on_card(dev, "red_mark")
    mark = torch.empty((q,), dtype=torch.bool, device=dev)
    admit = torch.empty((q,), dtype=torch.int32, device=dev)
    trim = torch.empty((q,), dtype=torch.int32, device=dev)
    build.check(_fn()(p_q, p_a, _P(mark.data_ptr()), _P(admit.data_ptr()),
                      _P(trim.data_ptr()), q, _i32(cap), float(kmin), float(kmax),
                      _i32(tick), _i32(salt), build.stream(dev)), "red_mark")
    red_mark.launches += 1
    return mark, admit, trim


red_mark.launches = 0
