"""Mixture-of-Experts (the JAX package's ``models/moe.py``): token-choice
top-k routing with capacity-bounded dispatch, in three forms — the
one-hot einsum dispatch (capacity per batch row), the local-capacity form
(the sequence folded into ``moe_local_chunks`` routing groups) and the
sort-based dispatch (capacity global over the batch) — and the
Switch-style load-balance loss.

The JAX package runs all of it as einsums outside any Pallas kernel, so
this is plain PyTorch, with the JAX package's dtype chain: the router in
f32, the one-hots in bf16 under ``moe_bf16`` (else f32), the expert
products in bf16.  An expert-parallel deployment of this layer sends the
all-to-all traffic that ``collectives/bridge.py`` replays through the
simulator.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L
from repro_torch.sharding import P


def experts_init(generator, e, d_in, d_out, device, scale):
    """``[e, d_in, d_out]`` bf16 expert weights, ``N(0, 1) * scale`` drawn
    in f32 one expert at a time (a full-width expert stack is ~6 GB of
    bf16: drawing it whole in f32 would need twice that again)."""
    out = torch.empty((e, d_in, d_out), dtype=L.PARAM_DTYPE, device=device)
    if generator is not None:
        for i in range(e):
            out[i] = L.normal((d_in, d_out), generator, device, scale)
    return out


class MoE(nn.Module):
    """Parameters of one MoE FFN, in the JAX package's layout: ``router
    [d, E]`` f32, ``gate``/``up [E, d, F]`` and ``down [E, F, d]`` bf16."""

    def __init__(self, cfg, device, generator=None):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = nn.Parameter(L.normal((d, e), generator, device, 0.02,
                                            dtype=torch.float32))
        for name, d_in, d_out in (("gate", d, f), ("up", d, f), ("down", f, d)):
            self.register_parameter(name, nn.Parameter(
                experts_init(generator, e, d_in, d_out, device, d_in ** -0.5)))


def route(p, cfg, x2):
    """The router on tokens ``[..., d]``: (probs f32 ``[..., E]``, the top-k
    gate values renormalized over the k choices, their expert ids), the
    choices in descending probability, as ``lax.top_k`` orders them."""
    probs = torch.softmax(x2.float() @ p.router, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, cfg.top_k, dim=-1)
    return probs, gate_vals / gate_vals.sum(dim=-1, keepdim=True), gate_idx


def aux_loss(probs, gate_idx, e):
    """Switch-style load balance: ``E * sum_e(fraction routed to e * mean
    probability of e)``, over every token."""
    onehot = F.one_hot(gate_idx.long(), e).float()
    me = onehot.sum(dim=-2).reshape(-1, e).mean(dim=0)
    pe = probs.reshape(-1, e).mean(dim=0)
    return e * (me * pe).sum()


def _experts(p, xe):
    """The expert SwiGLU on buffers ``xe [E, ..., d]`` (bf16)."""
    sub = "e...d,edf->e...f"
    h = L.silu(torch.einsum(sub, xe, p.gate)) * torch.einsum(sub, xe, p.up)
    return torch.einsum("e...f,efd->e...d", h, p.down)


def expert_spec(cfg, sh, e, *rest):
    """The spec of an expert buffer ``[E, *rest]``: experts over the model
    axis under expert parallelism (``cfg.moe_ep``) where they divide it."""
    espec = sh.maybe(sh.model, e, "moe experts") if cfg.moe_ep else None
    return P(espec, *rest)


def moe_apply(p, cfg, x, sh=None):
    """x ``[B, S, d]`` -> (``[B, S, d]``, aux loss f32).  Capacity per batch
    row, ``max(1, ceil(int(cf * S * k) / E))``; the buffer position of a
    (token, choice) is its rank in a cumsum over tokens, then choices."""
    if cfg.moe_sorted:
        return moe_apply_sorted(p, cfg, x, sh)
    if cfg.moe_local_chunks > 1 and x.shape[1] % cfg.moe_local_chunks == 0:
        return moe_apply_local(p, cfg, x, sh)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = max(1, -(-int(cfg.capacity_factor * s * k) // e))

    probs, gate_vals, gate_idx = route(p, cfg, x)             # [B, S, E], [B, S, K] x2
    onehot = F.one_hot(gate_idx.long(), e).float()            # [B, S, K, E]
    flat = onehot.reshape(b, s * k, e)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(b, s, k, e)
    keep = (pos < cap) * onehot                               # drop overflow
    pos_cap = torch.clamp(pos, max=cap - 1).long()

    # dispatch / combine [B, S, E, C]; the one-hots in bf16 under moe_bf16
    ddt = torch.bfloat16 if cfg.moe_bf16 else torch.float32
    oh_cap = F.one_hot(pos_cap, cap).to(ddt)                  # [B, S, K, E, C]
    disp = (keep.to(ddt)[..., None] * oh_cap).sum(dim=2)
    comb = ((keep * gate_vals[..., None]).to(ddt)[..., None] * oh_cap).sum(dim=2)

    xe = torch.einsum("bsec,bsd->ebcd", disp, x.to(ddt)).to(x.dtype)   # [E, B, C, d]
    if sh is not None and sh.enabled:
        xe = sh.constrain(xe, expert_spec(cfg, sh, e, sh.batch, None, None))
    ye = _experts(p, xe)
    y = torch.einsum("bsec,ebcd->bsd", comb, ye.to(ddt)).float()
    return y.to(x.dtype), aux_loss(probs, gate_idx, e)


def moe_apply_local(p, cfg, x, sh=None):
    """Local-capacity routing: the sequence folded into
    ``moe_local_chunks`` routing groups, each with its own capacity."""
    b, s, d = x.shape
    n = cfg.moe_local_chunks
    sub = dataclasses.replace(cfg, moe_local_chunks=0)
    y, aux = moe_apply(p, sub, x.reshape(b * n, s // n, d), sh)
    return y.reshape(b, s, d), aux


def moe_apply_sorted(p, cfg, x, sh=None):
    """Sort-based dispatch: (token, choice) pairs sorted stably by expert,
    gathered into ``[E, C, d]`` buffers, capacity global over the batch.
    Each token's k contributions are summed in a fixed order (choice 0
    first), with no atomic adds, so a run is repeatable on the card."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    cap = max(1, -(-int(cfg.capacity_factor * t * k) // e))

    xf = x.reshape(t, d)
    probs, gate_vals, gate_idx = route(p, cfg, xf)            # [T, E], [T, K] x2
    exp_flat = gate_idx.reshape(t * k)
    tok_flat = torch.arange(t, device=x.device).repeat_interleave(k)
    order = torch.sort(exp_flat, stable=True).indices
    exp_s = exp_flat[order]
    first = torch.searchsorted(exp_s, exp_s, side="left")
    rank = torch.arange(t * k, device=x.device) - first       # position within expert
    keep = rank < cap
    buf = torch.where(keep, exp_s * cap + rank, e * cap)

    xe = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    xe[buf] = xf[tok_flat[order]]           # overflow rows all land on the spare row
    xe = xe[:e * cap].reshape(e, cap, d)
    if sh is not None and sh.enabled:
        xe = sh.constrain(xe, expert_spec(cfg, sh, e, None, None))
    ye = _experts(p, xe).reshape(e * cap, d)

    contrib = torch.where(keep[:, None], ye[torch.clamp(buf, max=e * cap - 1)],
                          torch.zeros((), dtype=ye.dtype, device=x.device))
    contrib = contrib.float() * gate_vals.reshape(t * k)[order][:, None]
    unsorted = torch.empty_like(contrib)
    unsorted[order] = contrib                                 # back to (token, choice)
    unsorted = unsorted.reshape(t, k, d)
    y = unsorted[:, 0]
    for j in range(1, k):
        y = y + unsorted[:, j]
    return y.reshape(b, s, d).to(x.dtype), aux_loss(probs, gate_idx, e)
