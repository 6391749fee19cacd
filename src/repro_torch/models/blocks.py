"""Decoder layers (the JAX package's ``models/blocks.py``): a pre-norm
mixer (attention or Mamba-2) and an optional dense SwiGLU FFN.

The JAX package stacks each pattern position's parameters over the
repetitions and scans over them; here the depth is a ``ModuleList`` of
``n_layers`` layers, layer ``l`` being pattern position
``l % len(pattern)``.  MoE, MLA and cross-attention are not ported.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.attention import Attention
from repro_torch.models.config import (FFN_DENSE, FFN_NONE, MIXER_ATTN,
                                       MIXER_MAMBA, LayerSpec)
from repro_torch.models.mamba2 import Mamba2


class SwiGLU(nn.Module):
    def __init__(self, d_model, d_ff, device, generator=None):
        super().__init__()
        for name, shape in (("gate", (d_model, d_ff)), ("up", (d_model, d_ff)),
                            ("down", (d_ff, d_model))):
            self.register_parameter(name, nn.Parameter(
                L.dense_init(generator, *shape, device), requires_grad=False))


class Layer(nn.Module):
    """One decoder layer: ``ln``, ``mixer`` and, for a dense FFN, ``ln2``
    and ``ffn`` (the JAX package's parameter names)."""

    def __init__(self, cfg, spec: LayerSpec, device, generator=None):
        super().__init__()
        if cfg.mla is not None or spec.mixer not in (MIXER_ATTN, MIXER_MAMBA):
            raise NotImplementedError(
                f"{cfg.name}: mixer {spec.mixer!r}{' (MLA)' if cfg.mla else ''} "
                f"is not ported (attention and Mamba-2 are)")
        if spec.ffn not in (FFN_DENSE, FFN_NONE):
            raise NotImplementedError(f"{cfg.name}: ffn {spec.ffn!r} is not ported "
                                      f"(dense and none are)")
        self.spec = spec
        ones = lambda: nn.Parameter(torch.ones(cfg.d_model, device=device),
                                    requires_grad=False)
        self.ln = ones()
        self.mixer = (Attention(cfg, device, generator) if spec.mixer == MIXER_ATTN
                      else Mamba2(cfg, device, generator))
        if spec.ffn == FFN_DENSE:
            self.ln2 = ones()
            self.ffn = SwiGLU(cfg.d_model, cfg.d_ff, device, generator)
