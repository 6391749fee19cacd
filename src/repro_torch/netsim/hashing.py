"""Deterministic counter-based hashing used for ECMP path selection and RED
marking decisions.  splitmix32-style mixing: stateless, vectorizes, bitwise
reproducible across hosts/devices (no RNG state threaded through the sim).

PyTorch cannot shift ``uint32`` tensors on the CPU, so every value is a
uint32 *held in int64* (``[0, 2**32)``).  Shifts and xors are then plain
int64 ops, and the wrapping uint32 product is kept exact by splitting one
factor into 16-bit halves, so no intermediate reaches 2**63.  Every
function also takes Python ints (the constant lanes of the callers), for
which the same arithmetic runs on the host.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9


def u32(x):
    """``x`` reinterpreted as uint32 (two's-complement wrap), in int64."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _MASK
    return int(x) & _MASK


def _mul32(x, m: int):
    """``x * m mod 2**32`` for ``x`` in ``[0, 2**32)``: the high half's
    product only matters in its low 16 bits, so every partial stays
    below 2**49."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * m + (((hi * m) & 0xFFFF) << 16)) & _MASK


def mix32(x):
    """Finalizer from murmur3/splitmix — good avalanche behavior."""
    x = u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _M2)
    x = x ^ (x >> 16)
    return x


def hash2(a, b):
    """Hash two lanes of uint32 into one."""
    return mix32((_mul32(u32(a), _GOLDEN) + mix32(b)) & _MASK)


def hash3(a, b, c):
    return hash2(hash2(a, b), c)


def uniform01(*lanes) -> torch.Tensor:
    """Deterministic uniform in [0, 1) from integer lanes (the first lane
    a tensor).  int64 -> f32 rounds to nearest even, exactly as the
    reference's uint32 -> f32 conversion does for values below 2**32."""
    h = lanes[0]
    for lane in lanes[1:]:
        h = hash2(h, lane)
    h = mix32(h)
    return h.to(torch.float32) * (1.0 / 4294967296.0)
