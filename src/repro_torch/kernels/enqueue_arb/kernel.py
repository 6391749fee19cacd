"""ctypes wrappers of the CUDA ``enqueue_rank`` and ``rr_pick`` kernels
(``csrc/enqueue_rank.cu``, ``csrc/rr_pick.cu``).

Each wrapper checks its operands (device, dtype, shape, contiguity),
allocates its outputs, launches on PyTorch's current stream, raises if
the launch failed, and counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int


def _fn(name, argtypes):
    fn = getattr(build.library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def enqueue_rank(gdst, ghead, gsize, *, cap: int, nq: int):
    """Rank / acceptance / ring slot over the ``[S, D]`` fan-in group rows
    (i32 inputs; returns i32 / bool / i32 ``[S, D]``)."""
    dev = gdst.device
    s, d = gdst.shape
    i32 = torch.int32
    ptrs = [build.require(x, n, i32, (s, d), dev)
            for x, n in ((gdst, "gdst"), (ghead, "ghead"), (gsize, "gsize"))]
    build.on_card(dev, "enqueue_rank")
    rank = torch.empty((s, d), dtype=i32, device=dev)
    acc = torch.empty((s, d), dtype=torch.bool, device=dev)
    pos = torch.empty((s, d), dtype=i32, device=dev)
    fn = _fn("repro_enqueue_rank", [_P] * 6 + [_I] * 4 + [_P])
    build.check(fn(*ptrs, _P(rank.data_ptr()), _P(acc.data_ptr()),
                   _P(pos.data_ptr()), s, d, int(cap), int(nq),
                   build.stream(dev)), "enqueue_rank")
    enqueue_rank.launches += 1
    return rank, acc, pos


enqueue_rank.launches = 0


def rr_pick(elig, rr, *, kmax: int):
    """Round-robin argmin over ``[N, K]`` bool eligibility rows with an
    i32 ``[N]`` cursor; returns ``(has, sel)`` as bool / i32 ``[N]``."""
    dev = elig.device
    n, k = elig.shape
    p_elig = build.require(elig, "elig", torch.bool, (n, k), dev)
    p_rr = build.require(rr, "rr", torch.int32, (n,), dev)
    build.on_card(dev, "rr_pick")
    has = torch.empty((n,), dtype=torch.bool, device=dev)
    sel = torch.empty((n,), dtype=torch.int32, device=dev)
    fn = _fn("repro_rr_pick", [_P] * 4 + [_I] * 3 + [_P])
    build.check(fn(p_elig, p_rr, _P(has.data_ptr()), _P(sel.data_ptr()),
                   n, k, int(kmax), build.stream(dev)), "rr_pick")
    rr_pick.launches += 1
    return has, sel


rr_pick.launches = 0
