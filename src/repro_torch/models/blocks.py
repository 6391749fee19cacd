"""Decoder layers (the JAX package's ``models/blocks.py``): a pre-norm
mixer (attention, cross-attention, MLA or Mamba-2) and an optional FFN
(dense SwiGLU or MoE), dispatched over the layer spec as the JAX
package's ``layer_init`` does.

The JAX package stacks each pattern position's parameters over the
repetitions and scans over them; here the depth is a ``ModuleList`` of
``n_layers`` layers, layer ``l`` being pattern position
``l % len(pattern)``.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.attention import Attention
from repro_torch.models.config import (FFN_DENSE, FFN_MOE, FFN_NONE, MIXER_ATTN,
                                       MIXER_CROSS, MIXER_MAMBA, LayerSpec)
from repro_torch.models.mamba2 import Mamba2
from repro_torch.models.mla import MLA
from repro_torch.models.moe import MoE


class SwiGLU(nn.Module):
    def __init__(self, d_model, d_ff, device, generator=None):
        super().__init__()
        for name, shape in (("gate", (d_model, d_ff)), ("up", (d_model, d_ff)),
                            ("down", (d_ff, d_model))):
            self.register_parameter(name, nn.Parameter(
                L.dense_init(generator, *shape, device), requires_grad=False))


class Layer(nn.Module):
    """One decoder layer: ``ln``, ``mixer`` and, unless the FFN is
    ``"none"``, ``ln2`` and ``ffn`` (the JAX package's parameter names).
    An attention or cross layer of an MLA config holds MLA, as there."""

    def __init__(self, cfg, spec: LayerSpec, device, generator=None):
        super().__init__()
        self.spec = spec
        ones = lambda: nn.Parameter(torch.ones(cfg.d_model, device=device),
                                    requires_grad=False)
        self.ln = ones()
        if spec.mixer in (MIXER_ATTN, MIXER_CROSS):
            self.mixer = (MLA(cfg, device, generator) if cfg.mla is not None
                          else Attention(cfg, device, generator))
        elif spec.mixer == MIXER_MAMBA:
            self.mixer = Mamba2(cfg, device, generator)
        else:
            raise ValueError(spec.mixer)
        if spec.ffn == FFN_NONE:
            return
        self.ln2 = ones()
        if spec.ffn == FFN_MOE:
            self.ffn = MoE(cfg, device, generator)
        elif spec.ffn == FFN_DENSE:
            self.ffn = SwiGLU(cfg.d_model, cfg.d_ff, device, generator)
        else:
            raise ValueError(spec.ffn)
