"""Shared building blocks (the JAX package's ``models/layers.py``).

Parameters keep the JAX package's layouts: a dense weight is ``[d_in,
d_out]`` and is applied as ``x @ w``; weights are bf16, norm scales f32.
Every function mirrors the reference's casts: norms and RoPE compute in
f32 and round once to the input's dtype.
"""

from __future__ import annotations

import torch

from repro_torch.sharding import held, replicate_like, sharded_dim

PARAM_DTYPE = torch.bfloat16


def normal(shape, generator, device, scale, dtype=PARAM_DTYPE):
    """``N(0, 1) * scale`` drawn in f32 from ``generator`` (on ``device``),
    cast to ``dtype``; without a generator, an uninitialised tensor (the
    weights of a model that ``load_state_dict`` fills)."""
    if generator is None:
        return torch.empty(shape, dtype=dtype, device=device)
    return (torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32) * scale).to(dtype)


def dense_init(generator, d_in, d_out, device, scale=None):
    scale = scale if scale is not None else d_in ** -0.5
    return normal((d_in, d_out), generator, device, scale)


def embed_init(generator, vocab, d_model, device):
    return normal((vocab, d_model), generator, device, 0.02)


def rmsnorm(x, w, eps=1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, positions):
    """positions: int[..., S] -> (cos, sin) [..., S, head_dim/2] f32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    inv = replicate_like(positions, 1.0 / torch.pow(float(theta), exps))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: [..., S, H, D]; cos/sin: [..., S, D/2] (broadcast over heads)."""
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s], dim=-1).to(x.dtype)


def silu(x):
    """``jax.nn.silu`` as the JAX package computes it: ``x * 1/(1+exp(-x))``
    with every operation rounded to ``x.dtype`` (``F.silu`` rounds once,
    from f32, and differs in the last bf16 bit on a third of the values)."""
    return x * (1 / (1 + torch.exp(-x)))


def swiglu(p, x, sh=None):
    """``p`` holds ``gate``, ``up`` [d_model, d_ff] and ``down`` [d_ff, d_model]."""
    h = silu(held(x @ p.gate)) * held(x @ p.up)
    if sh is not None:
        h = sh.constrain_ffn(h)
    return h @ p.down



def cross_entropy(logits, labels, mask=None):
    """logits ``[B, S, V]`` (any float dtype), labels int ``[B, S]`` -> the
    mean negative log-likelihood in f32; with a mask, its sum over the
    mask's divided by ``max(sum(mask), 1)``.  Logits sharded over their
    vocab dim (a DTensor) take ``vocab_parallel_nll``."""
    if sharded_dim(logits, -1):
        nll = vocab_parallel_nll(logits, labels)
    else:
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def vocab_parallel_nll(logits, labels):
    """The negative log-likelihood ``logsumexp(x) - x[label]`` of logits
    sharded over the vocab, each rank over its own columns: the max and
    the sum of exponentials are reduced over the shards (small), the
    label's logit picked where it lives; the logits are never gathered."""
    lf = logits.float()
    m = lf.amax(dim=-1, keepdim=True).detach()
    lse = m[..., 0] + torch.log(torch.exp(lf - m).sum(dim=-1))
    vocab = replicate_like(lf, torch.arange(lf.shape[-1], device=lf.device))
    hit = vocab == labels[..., None].long()
    return lse - torch.where(hit, lf, torch.zeros_like(lf)).sum(dim=-1)
