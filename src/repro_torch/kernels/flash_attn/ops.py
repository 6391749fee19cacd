"""Backend dispatch for flash_attention (the JAX package's
``flash_attn/ops.py::gqa_flash_attention`` without its TPU block halving).

``"kernel"`` launches the CUDA kernel for CUDA tensors and takes the
plain version for CPU tensors; ``"plain"`` always takes the plain version.
"""

from __future__ import annotations

from repro_torch.kernels import build
from repro_torch.kernels.flash_attn import kernel as K
from repro_torch.kernels.flash_attn import ref as R

BACKENDS = ("kernel", "plain")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    backend: str = "kernel"):
    """q ``[B, Hq, Sq, D]``, k/v ``[B, Hkv, Sk, D]`` (any strides with a
    unit innermost one) -> ``[B, Hq, Sq, D]`` in ``q.dtype``."""
    if backend not in BACKENDS:
        raise KeyError(f"unknown attention backend {backend!r}; have {BACKENDS}")
    if build.use_kernel(backend, q):
        return K.flash_attention(q, k, v, causal=causal, window=window)
    return R.flash_attention_ref(q, k, v, causal=causal, window=window)
