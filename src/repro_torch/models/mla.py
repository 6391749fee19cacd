"""Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 style; the JAX
package's ``models/mla.py``).

Queries and KV are low-rank compressed; decode caches only the latent
``c_kv`` and a shared single-head RoPE key.  Prefill expands the latents
to per-head K/V and runs the ``flash_attention`` kernel with q/k of
``qk_nope + qk_rope`` columns and v of ``v_head_dim`` (the kernel's scale
``D^-0.5`` is MLA's ``(qk_nope + qk_rope)^-0.5``).  Decode is the absorbed
form: attention in latent space, plain f32 products as in the JAX
package, no kernel.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.sharding import held, merge_heads, put_rows_, replicate_like, split_heads

NEG_INF = -1e30


class MLA(nn.Module):
    """Parameters of one MLA block, in the JAX package's layout:
    ``wdq [d, Rq]``, ``q_ln [Rq]``, ``wuq [Rq, H*(Dn+Dr)]``, ``wdkv [d, R]``,
    ``kv_ln [R]``, ``wukv [R, H*(Dn+Dv)]``, ``wkr [d, Dr]``, ``wo [H*Dv, d]``."""

    def __init__(self, cfg, device, generator=None):
        super().__init__()
        m = cfg.mla
        d, h = cfg.d_model, cfg.n_heads
        qk = m.qk_nope_dim + m.qk_rope_dim

        def dense(name, d_in, d_out, scale=None):
            self.register_parameter(name, nn.Parameter(
                L.dense_init(generator, d_in, d_out, device, scale)))

        def norm(name, n):
            self.register_parameter(name, nn.Parameter(
                torch.ones(n, dtype=torch.float32, device=device)))

        dense("wdq", d, m.q_lora_rank)
        norm("q_ln", m.q_lora_rank)
        dense("wuq", m.q_lora_rank, h * qk)
        dense("wdkv", d, m.kv_lora_rank)
        norm("kv_ln", m.kv_lora_rank)
        dense("wukv", m.kv_lora_rank, h * (m.qk_nope_dim + m.v_head_dim))
        dense("wkr", d, m.qk_rope_dim)
        dense("wo", h * m.v_head_dim, d, scale=(h * m.v_head_dim) ** -0.5)


def mla_latents(p, cfg, x, positions):
    """Compressed latents: c_kv ``[B, S, R]``, k_rope ``[B, S, 1, Dr]`` (RoPE'd)."""
    m = cfg.mla
    c_kv = L.rmsnorm(held(x @ p.wdkv), p.kv_ln, cfg.rms_eps)
    k_rope = (x @ p.wkr).reshape(*x.shape[:-1], 1, m.qk_rope_dim)
    cos, sin = L.rope_freqs(m.qk_rope_dim, cfg.rope_theta, positions)
    return c_kv, L.apply_rope(k_rope, cos, sin)


def mla_queries(p, cfg, x, positions):
    """q_nope ``[B, S, H, Dn]``, q_rope ``[B, S, H, Dr]``."""
    m = cfg.mla
    q = L.rmsnorm(held(x @ p.wdq), p.q_ln, cfg.rms_eps) @ p.wuq
    q = split_heads(q, cfg.n_heads, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    cos, sin = L.rope_freqs(m.qk_rope_dim, cfg.rope_theta, positions)
    return q_nope, L.apply_rope(q_rope, cos, sin)


def mla_apply(p, cfg, x, positions, sh=None, backend: str = "kernel"):
    """Prefill: expand the latents to per-head K/V and attend causally over
    the concatenated (nope | rope) head dims.  Returns (output ``[B, S,
    d]``, c_kv, k_rope): the latents are the decode cache's rows."""
    m = cfg.mla
    h = cfg.n_heads
    q_nope, q_rope = mla_queries(p, cfg, x, positions)
    c_kv, k_rope = mla_latents(p, cfg, x, positions)
    kv = split_heads(c_kv @ p.wukv, h, m.qk_nope_dim + m.v_head_dim)
    k_nope, v = kv[..., :m.qk_nope_dim], kv[..., m.qk_nope_dim:]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:-1], m.qk_rope_dim)], dim=-1)
    if sh is not None:
        q, k, v = sh.constrain_heads(q), sh.constrain_heads(k), sh.constrain_heads(v)
    out = A.gqa(q, k, v, causal=True, backend=backend, score_dtype=A.score_dtype(cfg),
                sh=sh)
    return merge_heads(out) @ p.wo, c_kv, k_rope


def mla_decode(p, cfg, x1, positions, ckv_cache, krope_cache, cache_len):
    """Absorbed-matrix decode, x1 ``[B, 1, d]``; ckv_cache ``[B, S, R]`` and
    krope_cache ``[B, S, Dr]`` (bf16) take this token's latent at row
    ``cache_len - 1`` in place before the attention reads them back in
    f32; cache_len int ``[B]`` includes this token.  Returns ``[B, 1, d]``."""
    m = cfg.mla
    h = cfg.n_heads
    q_nope, q_rope = mla_queries(p, cfg, x1, positions)      # [B,1,H,*]
    c_kv, k_rope = mla_latents(p, cfg, x1, positions)        # [B,1,R],[B,1,1,Dr]
    at = (cache_len - 1).long()
    put_rows_(ckv_cache, c_kv[:, 0], at)
    put_rows_(krope_cache, k_rope[:, 0, 0], at)

    # absorb W_uk into the query: q_lat [B, H, R]
    wukv = split_heads(p.wukv, h, m.qk_nope_dim + m.v_head_dim)
    w_uk = wukv[..., :m.qk_nope_dim].float()                 # [R, H, Dn]
    w_uv = wukv[..., m.qk_nope_dim:].float()                 # [R, H, Dv]
    ckv = ckv_cache.float()
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(), w_uk)
    scores = torch.einsum("bhr,bsr->bhs", q_lat, ckv)
    scores = scores + torch.einsum("bhd,bsd->bhs", q_rope[:, 0].float(),
                                   krope_cache.float())
    scores = scores * (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    pos = replicate_like(cache_len, torch.arange(ckv.shape[1], device=x1.device))[None, None, :]
    scores = torch.where(pos < cache_len[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    lat = torch.einsum("bhs,bsr->bhr", probs, ckv)
    out = torch.einsum("bhr,rhd->bhd", lat, w_uv)
    return merge_heads(out)[:, None].to(x1.dtype) @ p.wo
