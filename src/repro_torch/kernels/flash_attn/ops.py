"""Backend dispatch for flash_attention (the JAX package's
``flash_attn/ops.py::gqa_flash_attention`` without its TPU block halving).

``"kernel"`` launches the CUDA kernel for CUDA tensors and takes the
plain version for CPU tensors; ``"plain"`` always takes the plain version.
``"dense"`` takes the naive oracle ``attention_ref`` (the same function,
one product a head over every key): the dry run's, whose fake tensors
carry no data and run every operation in Python, where the plain
version's 64 x 64 tiles would be thousands of operations a layer; its
operations are those of the JAX package's jnp attention, which visits
every tile.

Under autograd the kernel is the forward of :class:`FlashAttention`; its
backward is plain PyTorch: it recomputes the same function through the
dense oracle ``attention_ref`` and differentiates that (the kernel keeps
no log-sum-exp, and the JAX package has no backward kernel either: its
``jax.grad`` differentiates the jnp version).  The plain backend is
differentiated by autograd directly.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attn import kernel as K
from repro_torch.kernels.flash_attn import ref as R

BACKENDS = ("kernel", "plain", "dense")


class FlashAttention(torch.autograd.Function):
    """The kernel's forward, a plain backward.  The backward recomputes
    ``attention_ref`` (one product a head, not the kernel's 64 x 64 tiles,
    which would leave thousands of autograd nodes a layer) from the saved
    q, k, v and returns its gradients; autograd carries them back through
    the caller's views (``gqa``'s transposes, MLA's slice of v)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, score_dtype=torch.float32):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return K.flash_attention(q, k, v, causal=causal, window=window,
                                 score_dtype=score_dtype)

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
            out = R.attention_ref(*ins, causal=ctx.causal, window=ctx.window)
            wrt = [t for t in ins if t.requires_grad]
            got = iter(torch.autograd.grad(out, wrt, grad_out.float()))
        return (*(next(got) if n else None for n in need), None, None, None)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    backend: str = "kernel", score_dtype=torch.float32):
    """q ``[B, Hq, Sq, D]``, k ``[B, Hkv, Sk, D]``, v ``[B, Hkv, Sk, Dv]``
    (any strides with a unit innermost one) -> ``[B, Hq, Sq, Dv]`` in
    ``q.dtype``.  ``score_dtype=torch.bfloat16`` (``cfg.attn_bf16``) rounds
    the scores and probabilities to bf16: on the card, the tensor-core
    kernel's bf16-score variant (bf16 operands; f32 ones raise
    ``ValueError``), whose backward is the same dense f32 recompute as for
    f32 scores; ``"dense"`` keeps f32 scores."""
    if backend not in BACKENDS:
        raise KeyError(f"unknown attention backend {backend!r}; have {BACKENDS}")
    if build.use_kernel(backend, q):
        return FlashAttention.apply(q, k, v, causal, window, score_dtype)
    if backend == "dense":
        return R.attention_ref(q, k, v, causal=causal, window=window).to(q.dtype)
    return R.flash_attention_ref(q, k, v, causal=causal, window=window,
                                 score_dtype=score_dtype)
