"""Backend dispatch for flash_attention (the JAX package's
``flash_attn/ops.py::gqa_flash_attention`` without its TPU block halving).

``"kernel"`` launches the CUDA kernel for CUDA tensors and takes the
plain version for CPU tensors; ``"plain"`` always takes the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attn import kernel as K
from repro_torch.kernels.flash_attn import ref as R

BACKENDS = ("kernel", "plain")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    backend: str = "kernel", score_dtype=torch.float32):
    """q ``[B, Hq, Sq, D]``, k ``[B, Hkv, Sk, D]``, v ``[B, Hkv, Sk, Dv]``
    (any strides with a unit innermost one) -> ``[B, Hq, Sq, Dv]`` in
    ``q.dtype``.  ``score_dtype`` other than f32 (``cfg.attn_bf16``) is
    taken by the plain version only: a CUDA operand with the ``"kernel"``
    backend raises ``ValueError``."""
    if backend not in BACKENDS:
        raise KeyError(f"unknown attention backend {backend!r}; have {BACKENDS}")
    if build.use_kernel(backend, q):
        if score_dtype != torch.float32:
            raise ValueError(f"score_dtype {score_dtype} (attn_bf16): the flash_attention "
                             f"kernels keep f32 scores; use backend='plain'")
        return K.flash_attention(q, k, v, causal=causal, window=window)
    return R.flash_attention_ref(q, k, v, causal=causal, window=window,
                                 score_dtype=score_dtype)
