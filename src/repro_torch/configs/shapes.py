"""Assigned input shapes x step kinds (the JAX package's
``configs/shapes.py``), with ``meta``-device stand-ins for every input.

  train_4k      seq=4096    global_batch=256   train_step
  prefill_32k   seq=32768   global_batch=32    serve prefill
  decode_32k    seq=32768   global_batch=128   serve decode (1 new token,
                                               KV cache of seq_len)
  long_500k     seq=524288  global_batch=1     long-context decode —
                                               SSM/hybrid only (sub-quadratic);
                                               skipped for pure full-attention
                                               archs.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import MIXER_MAMBA, ModelConfig


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq: int
    global_batch: int
    kind: str                   # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}


def is_subquadratic(cfg: ModelConfig) -> bool:
    return any(s.mixer == MIXER_MAMBA for s in cfg.pattern)


def applicable_shapes(cfg: ModelConfig):
    """long_500k only for SSM/hybrid families."""
    return [s for s in SHAPES.values()
            if s.name != "long_500k" or is_subquadratic(cfg)]


def input_specs(cfg: ModelConfig, shape: Shape, *, batch: int | None = None,
                device="meta"):
    """Stand-ins (empty tensors on ``device``, ``meta`` by default: shapes
    and dtypes, no data) for every model input of this cell:

      train   -> {"batch": {tokens/embeds, labels[, cross]}}
      prefill -> {"batch": {tokens/embeds[, cross]}, "max_len": seq}
      decode  -> {"batch": {tokens/embeds}, "caches": ..., "cache_len": ...}
    """
    from repro_torch.models import lm

    b = batch or shape.global_batch
    d = cfg.d_model
    emb = torch.bfloat16

    def sd(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=device)

    def front(s):
        if cfg.frontend == "tokens":
            return {"tokens": sd((b, s), torch.int32)}
        return {"embeds": sd((b, s, d), emb)}

    if shape.kind == "train":
        batch_spec = dict(front(shape.seq))
        batch_spec["labels"] = sd((b, shape.seq), torch.int32)
        if cfg.cross_kv_len:
            batch_spec["cross"] = sd((b, cfg.cross_kv_len, d), emb)
        return {"batch": batch_spec}

    if shape.kind == "prefill":
        batch_spec = dict(front(shape.seq))
        if cfg.cross_kv_len:
            batch_spec["cross"] = sd((b, cfg.cross_kv_len, d), emb)
        return {"batch": batch_spec, "max_len": shape.seq}

    # decode: one new token against a cache of length seq
    return {
        "batch": dict(front(1)),
        "caches": lm.init_cache(cfg, b, shape.seq, device),
        "cache_len": sd((b,), torch.int32),
    }


def synth_inputs(cfg: ModelConfig, shape: Shape, seed: int, *, batch: int | None = None,
                 device="cuda"):
    """Concrete random inputs matching ``input_specs``, drawn from a
    ``torch.Generator`` seeded with ``seed`` (the values are not the JAX
    package's: its RNG is its own; the shapes and dtypes are)."""
    specs = input_specs(cfg, shape, batch=batch)
    g = torch.Generator(device=device).manual_seed(seed)

    def realize(t):
        if t.dtype == torch.int32:
            return torch.randint(0, max(cfg.vocab, 2), t.shape, generator=g,
                                 device=device, dtype=torch.int32)
        return (torch.randn(t.shape, generator=g, device=device) * 0.02).to(t.dtype)

    out = {}
    for name, v in specs.items():
        if name == "batch":
            out["batch"] = {k: realize(t) for k, t in v.items()}
        elif name == "caches":
            out["caches"] = [{k: torch.zeros(t.shape, dtype=t.dtype, device=device)
                              for k, t in c.items()} for c in v]
        elif name == "cache_len":
            out["cache_len"] = torch.full(v.shape, shape.seq, dtype=torch.int32,
                                          device=device)
        else:
            out[name] = v
    return out
