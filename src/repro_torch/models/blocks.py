"""Decoder layers (the JAX package's ``models/blocks.py``): a pre-norm
mixer (attention, cross-attention, MLA or Mamba-2) and an optional FFN
(dense SwiGLU or MoE), dispatched over the layer spec as the JAX
package's ``layer_init`` does; ``layer_apply`` is one layer's
whole-sequence forward and ``stack_apply`` the training forward of the
depth.

The JAX package stacks each pattern position's parameters over the
repetitions and scans over them; here the depth is a ``ModuleList`` of
``n_layers`` layers, layer ``l`` being pattern position
``l % len(pattern)``, and repetition ``r`` the layers ``r * len(pattern)``
to ``(r + 1) * len(pattern) - 1``.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import mla as MLA_
from repro_torch.models import moe as MOE
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
                L.dense_init(generator, *shape, device)))


class Layer(nn.Module):
    """One decoder layer: ``ln``, ``mixer`` and, unless the FFN is
    ``"none"``, ``ln2`` and ``ffn`` (the JAX package's parameter names).
    An attention or cross layer of an MLA config holds MLA, as there."""

    def __init__(self, cfg, spec: LayerSpec, device, generator=None):
        super().__init__()
        self.spec = spec
        ones = lambda: nn.Parameter(torch.ones(cfg.d_model, device=device))
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


def ffn_apply(layer, cfg, x, sh=None):
    """The FFN half of a layer with its residual: (x, the MoE aux loss, or
    ``None`` for a dense FFN or none)."""
    if layer.spec.ffn == FFN_NONE:
        return x, None
    h2 = L.rmsnorm(x, layer.ln2, cfg.rms_eps)
    if sh is not None:
        h2 = sh.whole_seq(h2)
    if layer.spec.ffn == FFN_MOE:
        out, aux = MOE.moe_apply(layer.ffn, cfg, h2, sh)
    else:
        out, aux = L.swiglu(layer.ffn, h2, sh), None
    return x + (out if sh is None else sh.whole_seq(out)), aux


def layer_apply(layer, cfg, x, positions, sh=None, cross_feed=None, backend: str = "kernel"):
    """The training / eval forward of one layer over the whole sequence:
    (x, aux loss f32, 0 without a MoE FFN).  Under ``sh`` the residual
    stream is constrained after the mixer and after the FFN."""
    p = layer.mixer
    h = L.rmsnorm(x, layer.ln, cfg.rms_eps)
    if sh is not None:
        h = sh.whole_seq(h)
    if layer.spec.mixer == MIXER_CROSS:
        mix = A.attn_apply(p, cfg, h, None, sh, cross_feed=cross_feed, backend=backend)[0]
    elif layer.spec.mixer == MIXER_ATTN:
        mix = (MLA_.mla_apply(p, cfg, h, positions, sh, backend=backend)[0]
               if cfg.mla is not None
               else A.attn_apply(p, cfg, h, positions, sh, backend=backend)[0])
    else:
        mix = M.mamba_apply(p, cfg, h, sh, backend=backend)
    if sh is not None:
        mix = sh.whole_seq(mix)
    x = x + mix
    if sh is not None:
        x = sh.constrain_act(x)
    x, aux = ffn_apply(layer, cfg, x, sh)
    if sh is not None and layer.spec.ffn != FFN_NONE:
        x = sh.constrain_act(x)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def _repetition(layers, cfg, x, positions, sh, cross_feed, backend):
    """One repetition of the pattern (the JAX package's scan body)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in layers:
        x, a = layer_apply(layer, cfg, x, positions, sh, cross_feed, backend)
        aux = aux + a
    return x, aux


def stack_apply(layers, cfg, x, positions, sh=None, cross_feed=None, *, remat: bool = True,
                backend: str = "kernel"):
    """The depth, one repetition of the pattern at a time: (x, the aux
    losses summed).  ``remat`` wraps each repetition in
    ``torch.utils.checkpoint`` (non-reentrant), where the JAX package puts
    ``jax.checkpoint`` around its scan body: only a repetition's input is
    kept, and the backward runs the repetition again, the kernels (and,
    under ``sh``, the collectives) included.  The recompute must equal the
    forward: the kernels add without atomics and MoE routing is the same
    function of the same input."""
    npat = len(cfg.pattern)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for r in range(cfg.repeats):
        args = (layers[r * npat:(r + 1) * npat], cfg, x, positions, sh, cross_feed, backend)
        x, a = (checkpoint(_repetition, *args, use_reentrant=False) if remat
                else _repetition(*args))
        aux = aux + a
    return x, aux
