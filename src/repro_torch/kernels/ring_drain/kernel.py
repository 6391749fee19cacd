"""ctypes wrapper of the CUDA ``ring_drain`` kernel (``csrc/ring_drain.cu``).

Checks its operands (device, dtype, shape, contiguity — the loss words
and the dedupe bitmap may be row-strided views, the kernel takes their
row strides), allocates its outputs, launches on PyTorch's current
stream, raises if the launch failed, and counts its launches in
``ring_drain.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int


def _fn():
    fn = build.library().repro_ring_drain
    fn.argtypes = ([_I, _P, _P, _P, _P, _P, _I, _P, _I, _I, _P, _P, _P, _I, _I]
                   + [_P] * 4 + [_P])
    fn.restype = ctypes.c_int
    return fn


def ring_drain(t: int, rto, started, has_ack, ack_seq, lbits, bitmap,
               sent0, sent1, sent2):
    """Same contract as ``ref.ring_drain_ref`` on CUDA tensors; returns
    ``(state', n_to, spur, unacked_pkts)``."""
    dev = sent0.device
    f, w = sent0.shape
    ww, maxw = lbits.shape[1], bitmap.shape[1]
    if ww * 32 != w:
        raise ValueError(f"lbits has {ww} words for a ring of width {w}")
    i32, b8 = torch.int32, torch.bool
    p_rto = build.require(rto, "rto", torch.float32, (f,), dev)
    p_started = build.require(started, "started", b8, (f,), dev)
    p_has = build.require(has_ack, "has_ack", b8, (f,), dev)
    p_seq = build.require(ack_seq, "ack_seq", i32, (f,), dev)
    p_lbits = build.require(lbits, "lbits", i32, (f, ww), dev, last_dim_only=True)
    p_bitmap = build.require(bitmap, "bitmap", i32, (f, maxw), dev, last_dim_only=True)
    p_s = [build.require(x, f"sent{k}", i32, (f, w), dev)
           for k, x in enumerate((sent0, sent1, sent2))]
    build.on_card(dev, "ring_drain")
    state = torch.empty((f, w), dtype=i32, device=dev)
    counts = torch.empty((3, f), dtype=i32, device=dev)
    n_to, spur, un = counts[0], counts[1], counts[2]
    build.check(_fn()(int(t), p_rto, p_started, p_has, p_seq,
                      p_lbits, lbits.stride(0), p_bitmap, bitmap.stride(0), maxw,
                      *p_s, f, w,
                      _P(state.data_ptr()), _P(n_to.data_ptr()),
                      _P(spur.data_ptr()), _P(un.data_ptr()),
                      build.stream(dev)), "ring_drain")
    ring_drain.launches += 1
    return state, n_to, spur, un


ring_drain.launches = 0
