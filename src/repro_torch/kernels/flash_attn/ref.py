"""Plain PyTorch versions of the flash_attention kernel.

``attention_ref`` is the naive oracle (softmax(QKᵀ/√d)V, as the JAX
package's ``flash_attn/ref.py``).  ``flash_attention_ref`` is the
kernel's own algorithm: the online softmax over ``BLOCK_K`` key tiles
for each ``BLOCK_Q`` query tile, visiting the same tiles the CUDA kernel
visits, in f32, rounded once to ``q.dtype`` — the plain version that the
CPU runs and the card compares the kernel with.

Layout (both): q ``[B, Hq, Sq, D]``, k ``[B, Hkv, Sk, D]``, v ``[B, Hkv,
Sk, Dv]`` (``Dv`` may differ from ``D``: MLA) with ``Hq % Hkv == 0`` (query
head ``h`` reads kv head ``h // (Hq // Hkv)``); the output is ``[B, Hq,
Sq, Dv]``, the scale ``D^-0.5``.
The ends of q and k are aligned: query row ``i`` sits at key position
``i + Sk - Sq``.  Masked scores are ``-1e30``, as in the JAX package, so
a row with no unmasked key averages every value, as there.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
BLOCK_Q = 64
BLOCK_K = 64


def _kv_heads(q, k, v):
    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    return k, v


def _mask(qpos, kpos, causal, window):
    mask = torch.ones(qpos.shape[0], kpos.shape[1], dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """Naive attention in f32; returns f32 ``[B, Hq, Sq, Dv]``."""
    k, v = _kv_heads(q, k, v)
    q, k, v = q.float(), k.float(), v.float()
    d = q.shape[-1]
    sq, sk = q.shape[2], k.shape[2]
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / (d ** 0.5)
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=q.device)[None, :]
    logits = torch.where(_mask(qpos, kpos, causal, window), logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    return torch.einsum("bhqk,bhkd->bhqd", e / e.sum(dim=-1, keepdim=True), v)


def key_tiles(q0: int, rows: int, sq: int, sk: int, causal: bool, window: int,
              block_k: int = BLOCK_K) -> range:
    """The key tiles that query rows ``[q0, q0 + rows)`` visit.

    When every row has an unmasked key, tiles wholly outside the union of
    the rows' key ranges change nothing (their weights are exactly 0, or
    exactly cancelled by the first unmasked score) and are skipped.
    Otherwise every tile is visited, as the TPU kernel does."""
    every = range(0, -(-sk // block_k))
    if rows <= 0 or sk <= 0:
        return every
    p_lo, p_hi = sk - sq + q0, sk - sq + q0 + rows - 1

    def lo(p):
        return max(0, p - window + 1) if window > 0 else 0

    def hi(p):
        return min(p, sk - 1) if causal else sk - 1

    # hi - lo is concave in p, so both ends non-empty => every row is
    if lo(p_lo) <= hi(p_lo) and lo(p_hi) <= hi(p_hi):
        return range(lo(p_lo) // block_k, hi(p_hi) // block_k + 1)
    return every


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        block_q: int = BLOCK_Q, block_k: int = BLOCK_K,
                        score_dtype=torch.float32):
    """The kernel's blocked online softmax; returns ``q.dtype``.

    ``score_dtype=torch.bfloat16`` rounds each tile's scores and
    probabilities to bf16, the softmax statistics staying f32, as the JAX
    package's ``blocked_attention(score_dtype=)`` does (``cfg.attn_bf16``);
    the tensor-core kernel's bf16-score variant does the same."""
    b, hq, sq, d = q.shape
    sk, dv = k.shape[2], v.shape[-1]
    k, v = _kv_heads(q, k, v)
    qf = q.float() * (d ** -0.5)
    kf, vf = k.float(), v.float()
    out = torch.empty((b, hq, sq, dv), dtype=q.dtype, device=q.device)
    for q0 in range(0, sq, block_q):
        rows = min(block_q, sq - q0)
        qt = qf[:, :, q0:q0 + rows]
        qpos = torch.arange(q0, q0 + rows, device=q.device)[:, None] + (sk - sq)
        m = torch.full((b, hq, rows, 1), NEG_INF, device=q.device)
        l = torch.zeros((b, hq, rows, 1), device=q.device)
        acc = torch.zeros((b, hq, rows, dv), device=q.device)
        for t in key_tiles(q0, rows, sq, sk, causal, window, block_k):
            k0 = t * block_k
            kt, vt = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
            kpos = torch.arange(k0, k0 + kt.shape[2], device=q.device)[None, :]
            s = torch.where(_mask(qpos, kpos, causal, window),
                            qt @ kt.transpose(-1, -2), NEG_INF)
            s = s.to(score_dtype).float()
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new).to(score_dtype).float()
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = alpha * acc + p @ vt
            m = m_new
        out[:, :, q0:q0 + rows] = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
    return out
