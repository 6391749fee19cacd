"""Deterministic counter-based hashing used for ECMP path selection and RED
marking decisions.  splitmix32-style mixing: stateless, vectorizes, bitwise
reproducible across hosts/devices (no RNG state threaded through the sim)."""

from __future__ import annotations

from . import np32 as jnp
import numpy as np

# numpy scalars so Pallas kernels see literals, not captured device constants
_M1 = np.uint32(0x85EBCA6B)
_M2 = np.uint32(0xC2B2AE35)
_GOLDEN = np.uint32(0x9E3779B9)


def mix32(x) -> jnp.ndarray:
    """Finalizer from murmur3/splitmix — good avalanche behavior."""
    x = jnp.asarray(x).astype(jnp.uint32)
    x = x ^ (x >> 16)
    x = x * _M1
    x = x ^ (x >> 13)
    x = x * _M2
    x = x ^ (x >> 16)
    return x


def hash2(a, b) -> jnp.ndarray:
    """Hash two lanes of uint32 into one."""
    a = jnp.asarray(a).astype(jnp.uint32)
    b = jnp.asarray(b).astype(jnp.uint32)
    return mix32(a * _GOLDEN + mix32(b))


def hash3(a, b, c) -> jnp.ndarray:
    return hash2(hash2(a, b), c)


def uniform01(*lanes) -> jnp.ndarray:
    """Deterministic uniform in [0, 1) from integer lanes."""
    h = lanes[0]
    for lane in lanes[1:]:
        h = hash2(h, lane)
    h = mix32(h)
    return h.astype(jnp.float32) * jnp.float32(1.0 / 4294967296.0)
