"""Language model (the JAX package's ``models/lm.py``): the frontend
(token embedding, or precomputed frame / patch embeddings) -> decoder
layers -> final norm -> head; the training forward and loss, and the
serving paths: the prefill that emits the caches and the single-token
decode step.

A model is built on the card unless the caller asks for the CPU::

    model = LM(get_config("qwen3-0.6b"), generator=g)        # cuda
    model = LM(cfg, device="cpu", generator=g)               # plain versions

``forward``, ``loss_fn``, ``prefill`` and ``decode_step`` take the JAX
package's batch dict —
``tokens`` int ``[B, S]`` or ``embeds`` ``[B, S, d]`` (the
``"embeddings"`` frontend), and ``cross`` ``[B, Sk, d]`` for a model with
cross-attention layers, ``labels`` int ``[B, S]`` (-1 masked) for the
loss — or a token tensor alone.

``backend`` selects how forward and prefill run the two kernels of the path:
``"kernel"`` launches ``flash_attention`` (self-attention, cross-attention,
MLA) and ``ssd_chunk_scan`` (Mamba-2) on a card (their plain versions on
the CPU), ``"plain"`` runs the plain versions everywhere, ``"dense"`` the
dry run's dense attention (``kernels/flash_attn/ops.py``).  Caches are a
list with one dict per layer; ``decode_step`` writes the new token's K/V
(or MLA latent) into the caches in place, leaves the cross caches as the
prefill wrote them, and replaces each Mamba cache.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as A
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models.blocks import Layer
from repro_torch.models.config import (FFN_MOE, FFN_NONE, MIXER_CROSS, MIXER_MAMBA,
                                       ModelConfig)
from repro_torch.sharding import P, is_dtensor, local_apply, put_rows_, replicate_like


class LM(nn.Module):
    """Parameters: ``embed [Vpad, D]`` (token frontend), ``layers.{l}.*``,
    ``final_norm`` and ``lm_head [D, Vpad]`` (unless the token embeddings
    are tied; always for the embeddings frontend).

    ``generator`` (a ``torch.Generator`` on ``device``) draws the seeded
    init, with the JAX package's distributions; without one the weights
    are left uninitialised for ``load_state_dict`` (``convert.py``)."""

    def __init__(self, cfg: ModelConfig, *, device="cuda", generator=None,
                 backend: str = "kernel"):
        super().__init__()
        if cfg.frontend not in ("tokens", "embeddings"):
            raise ValueError(f"{cfg.name}: frontend {cfg.frontend!r}")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("LM(device='cuda') needs a CUDA card; pass "
                               "device='cpu' for the plain versions on the CPU")
        self.cfg = cfg
        self.backend = backend
        self.layers = nn.ModuleList(
            Layer(cfg, cfg.pattern[i % len(cfg.pattern)], device, generator)
            for i in range(cfg.n_layers))
        self.final_norm = nn.Parameter(torch.ones(cfg.d_model, device=device))
        v, d = cfg.padded_vocab, cfg.d_model
        if cfg.frontend == "tokens":
            self.embed = nn.Parameter(L.embed_init(generator, v, d, device))
        if not cfg.tie_embeddings or cfg.frontend != "tokens":
            self.lm_head = nn.Parameter(L.dense_init(generator, d, v, device, scale=0.02))

    @property
    def device(self):
        return self.final_norm.device

    @property
    def has_cross(self) -> bool:
        return any(s.mixer == MIXER_CROSS for s in self.cfg.pattern)

    def head(self, x):
        w = self.lm_head if hasattr(self, "lm_head") else self.embed.T
        return x @ w

    def frontend(self, batch, sh=None):
        """The first layer's input ``[B, S, d]`` bf16 from a batch dict.
        Under ``sh``, a DTensor table is read on each rank's batch shard
        (``Shardings.local``) from the table gathered whole, its gradient
        each rank's batch share, summed over the data axes (DTensor's own
        rule for this lookup differs between PyTorch releases)."""
        if self.cfg.frontend == "tokens":
            tokens = batch["tokens"].long()
            if sh is not None and sh.enabled and is_dtensor(self.embed):
                b = sh.maybe(sh.batch, tokens.shape[0], "embedding batch")
                return sh.local(lambda e, t: e[t], P(b, None, None), (P(), P(b, None)),
                                self.embed, replicate_like(self.embed, tokens),
                                summed={0: b})
            return self.embed[tokens]
        return batch["embeds"].to(L.PARAM_DTYPE)


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda",
                backend: str = "kernel") -> LM:
    """The seeded model (the JAX package's ``init_params``): ``LM`` with
    its weights drawn from a generator on ``device`` seeded with ``seed``.
    The draws are PyTorch's, not JAX's: the JAX package's weights come
    across through ``convert.from_jax_params``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_params(device='cuda') needs a CUDA card; pass "
                           "device='cpu' for the plain versions on the CPU")
    g = torch.Generator(device=device).manual_seed(seed)
    return LM(cfg, device=device, generator=g, backend=backend)


def as_batch(batch) -> dict:
    """A token tensor alone stands for ``{"tokens": tensor}``."""
    return batch if isinstance(batch, dict) else {"tokens": batch}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               dtype=torch.bfloat16):
    """Per-layer caches: attention ``k``/``v [B, max_len, Hkv, Dh]``,
    cross-attention ``k``/``v [B, cross_kv_len, Hkv, Dh]`` and MLA
    ``ckv [B, max_len, R]``, ``kr [B, max_len, Dr]``, all in ``dtype``;
    Mamba ``ssm``/``conv_*`` in f32."""
    caches = []
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    for i in range(cfg.n_layers):
        mixer = cfg.pattern[i % len(cfg.pattern)].mixer
        if mixer == MIXER_MAMBA:
            caches.append(M.mamba_init_cache(cfg, batch, device))
        elif mixer == MIXER_CROSS:
            shape = (batch, cfg.cross_kv_len, cfg.n_kv_heads, cfg.head_dim_)
            caches.append({"k": zeros(*shape), "v": zeros(*shape)})
        elif cfg.mla is not None:
            m = cfg.mla
            caches.append({"ckv": zeros(batch, max_len, m.kv_lora_rank),
                           "kr": zeros(batch, max_len, m.qk_rope_dim)})
        else:
            shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
            caches.append({"k": zeros(*shape), "v": zeros(*shape)})
    return caches


def _pad_rows(t, max_len):
    """Pad dim 1 (the sequence) of ``t`` to ``max_len`` rows, as bf16 (a
    DTensor on each rank's shard: the sequence is never split)."""
    pad = [0, 0] * (t.dim() - 2) + [0, max_len - t.shape[1]]
    return local_apply(lambda x: torch.nn.functional.pad(x, pad).to(torch.bfloat16), t,
                       (t.shape[0], max_len, *t.shape[2:]))


@torch.no_grad()
def prefill_layer(model: LM, layer, x, positions, max_len: int, cross=None, sh=None):
    """One decoder layer of the prefill: returns (x, the layer's cache)."""
    cfg = model.cfg
    p = layer.mixer
    h = L.rmsnorm(x, layer.ln, cfg.rms_eps)
    if sh is not None:
        h = sh.whole_seq(h)
    if layer.spec.mixer == MIXER_MAMBA:
        mix, cache = M.mamba_apply(p, cfg, h, sh, return_state=True, backend=model.backend)
    elif layer.spec.mixer == MIXER_CROSS:
        mix, k, v = A.attn_apply(p, cfg, h, None, sh, cross_feed=cross,
                                 backend=model.backend)
        cache = {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}
    elif cfg.mla is not None:
        mix, ckv, kr = MLA.mla_apply(p, cfg, h, positions, sh, backend=model.backend)
        cache = {"ckv": _pad_rows(ckv, max_len), "kr": _pad_rows(kr[:, :, 0], max_len)}
    else:
        mix, k, v = A.attn_apply(p, cfg, h, positions, sh, backend=model.backend)
        cache = {"k": _pad_rows(k, max_len), "v": _pad_rows(v, max_len)}
    x = B.ffn_apply(layer, cfg, x + mix, sh)[0]
    if sh is not None:
        x = sh.constrain_act(x)
    return x, cache


def prefill_inputs(model: LM, batch, sh=None):
    """(x, positions, cross) of a prefill: the frontend's output, positions
    ``0..S-1`` and the cross feed cast to x's dtype (``None`` without
    one).  A model with cross-attention layers and no ``cross`` raises
    ``ValueError``.  Under ``sh`` the positions are a replicated DTensor
    when x is a DTensor, and x is constrained as the residual stream."""
    batch = as_batch(batch)
    x = model.frontend(batch, sh)
    bsz, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(bsz, s)
    if sh is not None:
        positions = replicate_like(x, positions)
        x = sh.constrain_act(x)
    cross = batch.get("cross")
    if cross is not None:
        cross = cross.to(x.dtype)
    elif model.has_cross:
        raise ValueError(f"{model.cfg.name} has cross-attention layers: the batch "
                         f"needs 'cross' [B, {model.cfg.cross_kv_len}, "
                         f"{model.cfg.d_model}]")
    return x, positions, cross


def head(model: LM, x, sh=None):
    """The logits of the final-normed x, vocab-sharded under ``sh``.  A
    DTensor x takes the head as a local product (``Shardings.local``):
    each rank multiplies its batch shard by its vocab columns, so the
    weight's gradient is each rank's batch share, summed over the data
    axes, and x's its columns' share, summed over the model axis (DTensor's
    own choice for this product, with tied embeddings and microbatches,
    asks for a placement it cannot size on fake tensors)."""
    if sh is not None and sh.enabled and is_dtensor(x):
        w = model.lm_head if hasattr(model, "lm_head") else model.embed.T
        b = sh.maybe(sh.batch, x.shape[0], "head batch")
        v = sh.maybe(sh.model, w.shape[1], "vocab")
        return sh.local(torch.matmul, P(b, None, v), (P(b, None, None), P(None, v)), x, w,
                        summed={0: v, 1: b})
    logits = model.head(x)
    if sh is not None:
        logits = sh.constrain_logits(logits)
    return logits


def forward(model: LM, batch, sh=None, remat: bool = True):
    """The training / eval forward of a batch dict (or tokens ``[B, S]``):
    (logits ``[B, S, Vpad]`` in the parameters' dtype, bf16, as the JAX
    package's; the MoE aux loss f32).  ``remat`` recomputes each
    repetition of the pattern in the backward (``blocks.stack_apply``).
    ``sh`` (``sharding.Shardings``) constrains the activations of a model
    whose parameters are DTensors (``launch.specs.distribute_model``)."""
    x, positions, cross = prefill_inputs(model, batch, sh)
    x, aux = B.stack_apply(model.layers, model.cfg, x, positions, sh, cross, remat=remat,
                           backend=model.backend)
    x = L.rmsnorm(x, model.final_norm, model.cfg.rms_eps)
    return head(model, x, sh), aux


def loss_fn(model: LM, batch, sh=None, remat: bool = True, aux_weight: float = 0.01):
    """(``nll + aux_weight * aux``, {"nll", "aux"}); ``batch["labels"]``
    of -1 are left out of the mean."""
    logits, aux = forward(model, batch, sh, remat)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    nll = L.cross_entropy(logits, torch.clamp(labels, min=0), mask)
    return nll + aux_weight * aux, {"nll": nll, "aux": aux}


@torch.no_grad()
def prefill(model: LM, batch, max_len: int, sh=None):
    """Process a prompt (a batch dict, or tokens ``[B, S]``); returns
    (logits ``[B, 1, Vpad]`` of the last position, caches allocated at
    ``max_len``, cache_len ``[B]``)."""
    x, positions, cross = prefill_inputs(model, batch, sh)
    caches = []
    for layer in model.layers:
        x, cache = prefill_layer(model, layer, x, positions, max_len, cross, sh)
        caches.append(cache)
    x = L.rmsnorm(x, model.final_norm, model.cfg.rms_eps)
    cache_len = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32, device=x.device)
    return head(model, x[:, -1:], sh), caches, cache_len


@torch.no_grad()
def decode_step(model: LM, batch, caches, cache_len, sh=None):
    """One new token (a batch dict of ``tokens [B, 1]`` or ``embeds [B, 1,
    d]``, or tokens alone) against the caches; ``cache_len [B]`` is the
    prefix length including this token, whose K/V (MLA: latent) go to row
    ``cache_len - 1``, in place (``sharding.put_rows_``: a DTensor cache on
    each rank's shard).  Returns (logits ``[B, 1, Vpad]``, caches)."""
    cfg = model.cfg
    x = model.frontend(as_batch(batch), sh)
    positions = (cache_len - 1)[:, None]
    at = (cache_len - 1).long()
    for i, layer in enumerate(model.layers):
        p = layer.mixer
        h = L.rmsnorm(x, layer.ln, cfg.rms_eps)
        if sh is not None:
            h = sh.constrain_dec(h)
        if layer.spec.mixer == MIXER_MAMBA:
            mix, caches[i] = M.mamba_decode(p, cfg, h, caches[i])
        elif layer.spec.mixer == MIXER_CROSS:
            q, _, _ = A.attn_qkv(p, cfg, h, h, None, sh)
            kc, vc = caches[i]["k"], caches[i]["v"]
            clen = torch.full_like(cache_len, kc.shape[1])
            out = A.decode_attention(q, kc, vc, clen)
            out = out.reshape(*x.shape[:-1], cfg.n_heads * cfg.head_dim_)
            if sh is not None:
                out = sh.constrain_ffn(out)   # contract-dim layout for wo
            mix = out @ p.wo
        elif cfg.mla is not None:
            mix = MLA.mla_decode(p, cfg, h, positions, caches[i]["ckv"], caches[i]["kr"],
                                 cache_len)
        else:
            q, k, v = A.attn_qkv(p, cfg, h, h, positions, sh)
            kc, vc = put_rows_(caches[i]["k"], k[:, 0], at), put_rows_(caches[i]["v"], v[:, 0], at)
            out = A.decode_attention(q, kc, vc, cache_len, window=cfg.sliding_window)
            out = out.reshape(*x.shape[:-1], cfg.n_heads * cfg.head_dim_)
            if sh is not None:
                out = sh.constrain_ffn(out)   # contract-dim layout for wo
            mix = out @ p.wo
        x = x + mix
        if layer.spec.ffn != FFN_NONE:
            h2 = L.rmsnorm(x, layer.ln2, cfg.rms_eps)
            if sh is not None:
                h2 = sh.constrain_dec(h2)
            x = x + (MOE.moe_apply(layer.ffn, cfg, h2, sh)[0] if layer.spec.ffn == FFN_MOE
                     else L.swiglu(layer.ffn, h2, sh))
    x = L.rmsnorm(x, model.final_norm, cfg.rms_eps)
    return head(model, x, sh), caches
