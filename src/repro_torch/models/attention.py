"""GQA self-attention and cross-attention (the JAX package's
``models/attention.py``, serving half): the q/k/v projection, prefill
attention through the ``flash_attention`` kernel (causal for
self-attention, non-causal over the cross feed's ``Sk`` keys for
cross-attention), and single-token decode attention.

``decode_attention`` stays plain PyTorch, as the JAX package computes it
outside any Pallas kernel.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.models import layers as L
from repro_torch.sharding import (P, divisible_split, merge_heads, replicate_dim,
                                  replicate_like, split_heads)

NEG_INF = -1e30


class Attention(nn.Module):
    """Parameters of one GQA attention block, in the JAX package's layout
    (``wq [d, Hq*Dh]``, ``wk``/``wv [d, Hkv*Dh]``, ``wo [Hq*Dh, d]``); a
    cross-attention block has the same parameters, its k/v projected from
    the cross feed."""

    def __init__(self, cfg, device, generator=None):
        super().__init__()
        d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        shapes = {"wq": (d, hq * dh), "wk": (d, hkv * dh), "wv": (d, hkv * dh),
                  "wo": (hq * dh, d)}
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                L.dense_init(generator, *shape, device)))
        if cfg.attn_bias:
            for name, n in (("bq", hq * dh), ("bk", hkv * dh), ("bv", hkv * dh)):
                self.register_parameter(name, nn.Parameter(
                    torch.zeros(n, dtype=L.PARAM_DTYPE, device=device)))
        if cfg.qk_norm:
            for name in ("q_norm", "k_norm"):
                self.register_parameter(name, nn.Parameter(
                    torch.ones(dh, dtype=torch.float32, device=device)))


def attn_qkv(p, cfg, x, kv_src, positions, sh=None):
    """Project to q, k, v (RoPE'd, normed); ``[B, S, H, Dh]`` each, heads
    placed over the model axis under ``sh``."""
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = x @ p.wq
    k = kv_src @ p.wk
    v = kv_src @ p.wv
    if cfg.attn_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q, k, v = split_heads(q, hq, dh), split_heads(k, hkv, dh), split_heads(v, hkv, dh)
    if cfg.qk_norm:
        q = L.rmsnorm(q, p.q_norm, cfg.rms_eps)
        k = L.rmsnorm(k, p.k_norm, cfg.rms_eps)
    if positions is not None:
        cos, sin = L.rope_freqs(dh, cfg.rope_theta, positions)
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)
    if sh is not None:
        q, k, v = sh.constrain_heads(q), sh.constrain_heads(k), sh.constrain_heads(v)
    return q, k, v


def score_dtype(cfg):
    """The dtype of the attention scores: bf16 under ``cfg.attn_bf16``
    (on the card, the flash kernel's bf16-score variant), else f32."""
    return torch.bfloat16 if cfg.attn_bf16 else torch.float32


def gqa(q, k, v, *, causal: bool = True, window: int = 0, backend: str = "kernel",
        score_dtype=torch.float32, sh=None):
    """Prefill attention, q ``[B, Sq, Hq, D]`` and k/v ``[B, Sk, Hkv, D]``
    layout (v may have its own head dim).  The kv heads are read in place
    by the kernel (the JAX package repeats them first: the same function);
    the transposes are views, which the kernel takes by their strides.

    Under ``sh`` with DTensor operands, each rank attends over its own
    shard (``Shardings.local``): the batch over the data axes, the q heads
    over the model axis where they divide it (with whole GQA groups a rank
    where the kv heads divide it too), else every head on every rank."""
    def attend(q, k, v):
        out = flash_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                        v.transpose(1, 2), causal=causal,
                                        window=window, backend=backend,
                                        score_dtype=score_dtype)
        return out.transpose(1, 2)

    if sh is None or not sh.enabled:
        return attend(q, k, v)
    b = sh.maybe(sh.batch, q.shape[0], "attention batch")
    n = sh.axis_size(sh.model)
    hq, hkv = q.shape[2], k.shape[2]
    h = sh.model if hq % n == 0 else None
    if h and hkv % n:
        # the q heads divide the axis and the kv heads do not: each kv head
        # is repeated for its q heads (as the JAX package's gqa does), so a
        # rank holds the kv heads its q heads read
        rep = hq // hkv
        k, v = (t.unsqueeze(3).expand(*t.shape[:3], rep, t.shape[3]).reshape(
            *t.shape[:2], hq, t.shape[3]) for t in (k, v))
    spec = P(b, None, h, None)
    return sh.local(attend, spec, (spec, spec, spec), q, k, v)


def attn_apply(p, cfg, x, positions, sh=None, *, cross_feed=None, backend: str = "kernel"):
    """The attention block's body (the caller owns the norm and the
    residual): causal self-attention over ``x``, or, given ``cross_feed``
    ``[B, Sk, d]``, non-causal cross-attention onto it with no RoPE.
    Returns (output ``[B, S, d]``, k, v): the k/v are the prefill's cache."""
    if cross_feed is not None:
        q, k, v = attn_qkv(p, cfg, x, cross_feed, None, sh)
        out = gqa(q, k, v, causal=False, backend=backend, score_dtype=score_dtype(cfg),
                  sh=sh)
    else:
        q, k, v = attn_qkv(p, cfg, x, x, positions, sh)
        out = gqa(q, k, v, causal=True, window=cfg.sliding_window, backend=backend,
                  score_dtype=score_dtype(cfg), sh=sh)
    return merge_heads(out) @ p.wo, k, v


def decode_attention(q1, k_cache, v_cache, cache_len, *, window: int = 0):
    """Single-token decode: q1 ``[B, 1, H, D]``; caches ``[B, S, Hkv, D]``;
    cache_len int ``[B]`` = valid prefix length (includes the new token).
    The caches are used in their storage dtype, the scores and softmax in
    f32, as in the JAX package."""
    b, s, hkv, d = k_cache.shape
    hq = q1.shape[2]
    rep = hq // hkv
    q = (q1[:, 0].float() * (d ** -0.5)).to(k_cache.dtype)
    qr = divisible_split(q, 1, hkv).reshape(b, hkv, rep, d)
    s_ = torch.einsum("bgrd,bsgd->bgrs", qr, k_cache).float().reshape(b, hq, s)
    pos = replicate_like(cache_len, torch.arange(s, device=q1.device))[None, None, :]
    mask = pos < cache_len[:, None, None]
    if window > 0:
        mask &= pos >= cache_len[:, None, None] - window
    s_ = torch.where(mask, s_, NEG_INF)
    p = torch.softmax(s_, dim=-1).to(v_cache.dtype)
    pr = divisible_split(p, 1, hkv).reshape(b, hkv, rep, s)
    out = torch.einsum("bgrs,bsgd->bgrd", pr, v_cache).float().reshape(b, hq, d)
    # a head_dim-sharded cache leaves out split along d: gathered (it is
    # tiny), so the caller's merge of the heads and d stays a plain shard
    return replicate_dim(out, -1)[:, None].to(q1.dtype)        # [B, 1, H, D]
