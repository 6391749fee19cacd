"""Language model, serving half (the JAX package's ``models/lm.py``):
token embedding -> decoder layers -> final norm -> tied head, with the
prefill that emits the caches and the single-token decode step.

A model is built on the card unless the caller asks for the CPU::

    model = LM(get_config("qwen3-0.6b"), generator=g)        # cuda
    model = LM(cfg, device="cpu", generator=g)               # plain versions

``backend`` selects how prefill runs the two kernels of the path:
``"kernel"`` launches ``flash_attention`` and ``ssd_chunk_scan`` on a
card (their plain versions on the CPU), ``"plain"`` runs the plain
versions everywhere.  Caches are a list with one dict per layer;
``decode_step`` writes the new token's K/V into the attention caches in
place and replaces each Mamba cache.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models.blocks import Layer
from repro_torch.models.config import FFN_NONE, MIXER_MAMBA, ModelConfig


class LM(nn.Module):
    """Parameters: ``embed [Vpad, D]``, ``layers.{l}.*``, ``final_norm``
    (and ``lm_head [D, Vpad]`` when the embeddings are not tied).

    ``generator`` (a ``torch.Generator`` on ``device``) draws the seeded
    init, with the JAX package's distributions; without one the weights
    are left uninitialised for ``load_state_dict`` (``convert.py``)."""

    def __init__(self, cfg: ModelConfig, *, device="cuda", generator=None,
                 backend: str = "kernel"):
        super().__init__()
        if cfg.frontend != "tokens":
            raise NotImplementedError(f"{cfg.name}: frontend {cfg.frontend!r} is not "
                                      f"ported (token models are)")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("LM(device='cuda') needs a CUDA card; pass "
                               "device='cpu' for the plain versions on the CPU")
        self.cfg = cfg
        self.backend = backend
        self.layers = nn.ModuleList(
            Layer(cfg, cfg.pattern[i % len(cfg.pattern)], device, generator)
            for i in range(cfg.n_layers))
        self.final_norm = nn.Parameter(torch.ones(cfg.d_model, device=device),
                                       requires_grad=False)
        v, d = cfg.padded_vocab, cfg.d_model
        self.embed = nn.Parameter(L.embed_init(generator, v, d, device),
                                  requires_grad=False)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(L.dense_init(generator, d, v, device, scale=0.02),
                                        requires_grad=False)

    @property
    def device(self):
        return self.embed.device

    def head(self, x):
        w = self.lm_head if hasattr(self, "lm_head") else self.embed.T
        return x @ w


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               dtype=torch.bfloat16):
    """Per-layer caches: attention ``k``/``v [B, max_len, Hkv, Dh]`` in
    ``dtype``; Mamba ``ssm``/``conv_*`` in f32."""
    caches = []
    for i in range(cfg.n_layers):
        if cfg.pattern[i % len(cfg.pattern)].mixer == MIXER_MAMBA:
            caches.append(M.mamba_init_cache(cfg, batch, device))
        else:
            shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
            caches.append({"k": torch.zeros(shape, dtype=dtype, device=device),
                           "v": torch.zeros(shape, dtype=dtype, device=device)})
    return caches


def _ffn(layer, cfg, x):
    if layer.spec.ffn == FFN_NONE:
        return x
    h2 = L.rmsnorm(x, layer.ln2, cfg.rms_eps)
    return x + L.swiglu(layer.ffn, h2)


@torch.no_grad()
def prefill_layer(model: LM, layer, x, positions, max_len: int):
    """One decoder layer of the prefill: returns (x, the layer's cache)."""
    cfg = model.cfg
    p = layer.mixer
    h = L.rmsnorm(x, layer.ln, cfg.rms_eps)
    if layer.spec.mixer == MIXER_MAMBA:
        mix, cache = M.mamba_apply(p, cfg, h, return_state=True, backend=model.backend)
    else:
        q, k, v = A.attn_qkv(p, cfg, h, h, positions)
        mix = A.gqa(q, k, v, causal=True, window=cfg.sliding_window,
                    backend=model.backend)
        mix = mix.reshape(*x.shape[:-1], cfg.n_heads * cfg.head_dim_) @ p.wo
        pad = (0, 0, 0, 0, 0, max_len - x.shape[1])
        cache = {"k": torch.nn.functional.pad(k, pad).to(torch.bfloat16),
                 "v": torch.nn.functional.pad(v, pad).to(torch.bfloat16)}
    return _ffn(layer, cfg, x + mix), cache


@torch.no_grad()
def prefill(model: LM, tokens, max_len: int):
    """Process a prompt ``[B, S]``; returns (logits ``[B, 1, Vpad]`` of the
    last position, caches allocated at ``max_len``, cache_len ``[B]``)."""
    x = model.embed[tokens.long()]
    bsz, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(bsz, s)
    caches = []
    for layer in model.layers:
        x, cache = prefill_layer(model, layer, x, positions, max_len)
        caches.append(cache)
    x = L.rmsnorm(x, model.final_norm, model.cfg.rms_eps)
    cache_len = torch.full((bsz,), s, dtype=torch.int32, device=x.device)
    return model.head(x[:, -1:]), caches, cache_len


@torch.no_grad()
def decode_step(model: LM, tokens, caches, cache_len):
    """One new token ``[B, 1]`` against the caches; ``cache_len [B]`` is
    the prefix length including this token, whose K/V go to row
    ``cache_len - 1``.  Returns (logits ``[B, 1, Vpad]``, caches)."""
    cfg = model.cfg
    x = model.embed[tokens.long()]
    positions = (cache_len - 1)[:, None]
    rows = torch.arange(x.shape[0], device=x.device)
    at = (cache_len - 1).long()
    for i, layer in enumerate(model.layers):
        p = layer.mixer
        h = L.rmsnorm(x, layer.ln, cfg.rms_eps)
        if layer.spec.mixer == MIXER_MAMBA:
            mix, caches[i] = M.mamba_decode(p, cfg, h, caches[i])
        else:
            q, k, v = A.attn_qkv(p, cfg, h, h, positions)
            kc, vc = caches[i]["k"], caches[i]["v"]
            kc[rows, at] = k[:, 0].to(kc.dtype)
            vc[rows, at] = v[:, 0].to(vc.dtype)
            out = A.decode_attention(q, kc, vc, cache_len, window=cfg.sliding_window)
            mix = out.reshape(*x.shape[:-1], cfg.n_heads * cfg.head_dim_) @ p.wo
        x = _ffn(layer, cfg, x + mix)
    x = L.rmsnorm(x, model.final_norm, cfg.rms_eps)
    return model.head(x), caches
