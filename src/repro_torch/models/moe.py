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
from repro_torch.sharding import P, is_dtensor, local_apply


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
    choices in descending probability, as ``lax.top_k`` orders them.
    ``p`` holds ``router``: the module, or ``Local`` in a rank's region."""
    probs = torch.softmax(x2.float() @ p.router, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, cfg.top_k, dim=-1)
    return probs, gate_vals / gate_vals.sum(dim=-1, keepdim=True), gate_idx


@dataclasses.dataclass(frozen=True, eq=False)
class Local:
    """A MoE module's router as a rank holds it inside a local region:
    ``route`` reads ``router`` (the local tensor); ``module`` is the
    module it belongs to."""
    module: nn.Module
    router: torch.Tensor


def load_means(probs, gate_idx, e, n):
    """The load-balance loss's two means over ``n`` tokens, of these
    tokens' shares: (fraction routed to each expert, mean probability of
    each expert), each ``[E]`` f32, the sums over these tokens divided by
    ``n``.  Summed over the ranks' token shards they are the means over
    every token."""
    onehot = F.one_hot(gate_idx.long(), e).float()
    return (onehot.sum(dim=-2).reshape(-1, e).sum(dim=0) / n,
            probs.reshape(-1, e).sum(dim=0) / n)


def aux_loss(me, pe, e):
    """Switch-style load balance: ``E * sum_e(fraction routed to e * mean
    probability of e)``."""
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


def _sharded(sh, x) -> bool:
    return sh is not None and sh.enabled and is_dtensor(x)


def _capacity(cfg, n) -> int:
    """Slots an expert for ``n`` tokens: ``max(1, ceil(int(cf * n * k) / E))``."""
    return max(1, -(-int(cfg.capacity_factor * n * cfg.top_k) // cfg.n_experts))


def dispatch(p, cfg, x, n):
    """Route tokens ``x [B, S, d]`` (whole rows: capacity is per row) and
    gather them into expert buffers: (xe ``[E, B, C, d]``, the combine
    weights ``[B, S, E, C]``, ``load_means`` over ``n`` tokens).  The
    buffer position of a (token, choice) is its rank in a cumsum over
    tokens, then choices; the one-hots are bf16 under ``moe_bf16``."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(cfg, s)
    probs, gate_vals, gate_idx = route(p, cfg, x)             # [B, S, E], [B, S, K] x2
    onehot = F.one_hot(gate_idx.long(), e).float()            # [B, S, K, E]
    flat = onehot.reshape(b, s * k, e)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(b, s, k, e)
    keep = (pos < cap) * onehot                               # drop overflow
    pos_cap = torch.clamp(pos, max=cap - 1).long()

    ddt = torch.bfloat16 if cfg.moe_bf16 else torch.float32
    oh_cap = F.one_hot(pos_cap, cap).to(ddt)                  # [B, S, K, E, C]
    disp = (keep.to(ddt)[..., None] * oh_cap).sum(dim=2)
    comb = ((keep * gate_vals[..., None]).to(ddt)[..., None] * oh_cap).sum(dim=2)
    xe = torch.einsum("bsec,bsd->ebcd", disp, x.to(ddt)).to(x.dtype)
    return (xe, comb, *load_means(probs, gate_idx, e, n))


def combine(comb, ye, dtype):
    """The experts' outputs ``ye [E, B, C, d]`` back to tokens ``[B, S, d]``."""
    return torch.einsum("bsec,ebcd->bsd", comb, ye.to(comb.dtype)).float().to(dtype)


def moe_apply(p, cfg, x, sh=None):
    """x ``[B, S, d]`` -> (``[B, S, d]``, aux loss f32).  Capacity per batch
    row, ``max(1, ceil(int(cf * S * k) / E))`` (``dispatch``).

    Under ``sh`` with a DTensor x, the routing and the dispatch run on each
    rank's batch rows, every row whole (the sequence gathered under
    sequence parallelism; ``Shardings.local``), so a row drops the tokens
    it drops unsharded; the router's gradient is each rank's share, summed
    over the data axes, and the load means are partial sums over them.
    The expert buffers enter the experts with the JAX package's spec
    (``expert_spec``) and the products run on the placed weights."""
    if cfg.moe_sorted:
        return moe_apply_sorted(p, cfg, x, sh)
    if cfg.moe_local_chunks > 1 and x.shape[1] % cfg.moe_local_chunks == 0:
        return moe_apply_local(p, cfg, x, sh)
    b, s, d = x.shape
    e = cfg.n_experts
    if not _sharded(sh, x):
        xe, comb, me, pe = dispatch(p, cfg, x, b * s)
        return combine(comb, _experts(p, xe), x.dtype), aux_loss(me, pe, e)
    ba = sh.batch_of(x)
    rows = P(ba, None, None)
    xe, comb, me, pe = sh.local(
        lambda x, w: dispatch(Local(p, w), cfg, x, b * s),
        (P(None, ba, None, None), P(ba, None, None, None), P(), P()),
        (rows, P()), x, p.router, summed={1: ba}, partial={2: ba, 3: ba})
    xe = sh.constrain(xe, expert_spec(cfg, sh, e, ba, None, None))
    ye = _experts(p, xe)
    y = sh.local(lambda c, y: combine(c, y, x.dtype), rows,
                 (P(ba, None, None, None), P(None, ba, None, None)), comb, ye)
    return y, aux_loss(me, pe, e)


def moe_apply_local(p, cfg, x, sh=None):
    """Local-capacity routing: the sequence folded into
    ``moe_local_chunks`` routing groups, each with its own capacity (under
    ``sh``, each rank folds its own rows, the sequence gathered)."""
    b, s, d = x.shape
    n = cfg.moe_local_chunks
    sub = dataclasses.replace(cfg, moe_local_chunks=0)
    if _sharded(sh, x):
        x = sh.constrain(x, P(sh.batch_of(x), None, None))
    y, aux = moe_apply(p, sub, local_apply(lambda t: t.reshape(-1, s // n, d), x,
                                           (b * n, s // n, d)), sh)
    return local_apply(lambda t: t.reshape(-1, s, d), y, (b, s, d)), aux


def sorted_dispatch(p, cfg, xf):
    """Sort-based routing of tokens ``xf [T, d]``, capacity global over the
    T tokens: (xe ``[E, C, d]``, the plan ``(keep, buf, order, gate values
    in sorted order)``, ``load_means``).  (token, choice) pairs are sorted
    stably by expert; a pair's slot is its rank within its expert."""
    t, d = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(cfg, t)
    probs, gate_vals, gate_idx = route(p, cfg, xf)            # [T, E], [T, K] x2
    exp_flat = gate_idx.reshape(t * k)
    tok_flat = torch.arange(t, device=xf.device).repeat_interleave(k)
    order = torch.sort(exp_flat, stable=True).indices
    exp_s = exp_flat[order]
    first = torch.searchsorted(exp_s, exp_s, side="left")
    rank = torch.arange(t * k, device=xf.device) - first      # position within expert
    keep = rank < cap
    buf = torch.where(keep, exp_s * cap + rank, e * cap)
    xe = torch.zeros((e * cap + 1, d), dtype=xf.dtype, device=xf.device)
    xe[buf] = xf[tok_flat[order]]           # overflow rows all land on the spare row
    plan = (keep, buf, order, gate_vals.reshape(t * k)[order])
    return (xe[:e * cap].reshape(e, cap, d), plan, *load_means(probs, gate_idx, e, t))


def sorted_combine(ye, keep, buf, order, gates, k):
    """The experts' outputs ``ye [E, C, d]`` back to tokens ``[T, d]`` f32:
    each token's k contributions summed in a fixed order (choice 0
    first), with no atomic adds, so a run is repeatable on the card."""
    e, cap, d = ye.shape
    ye = ye.reshape(e * cap, d)
    contrib = torch.where(keep[:, None], ye[torch.clamp(buf, max=e * cap - 1)],
                          torch.zeros((), dtype=ye.dtype, device=ye.device))
    contrib = contrib.float() * gates[:, None]
    unsorted = torch.empty_like(contrib)
    unsorted[order] = contrib                                 # back to (token, choice)
    unsorted = unsorted.reshape(-1, k, d)
    y = unsorted[:, 0]
    for j in range(1, k):
        y = y + unsorted[:, j]
    return y


def moe_apply_sorted(p, cfg, x, sh=None):
    """Sort-based dispatch: (token, choice) pairs sorted stably by expert,
    gathered into ``[E, C, d]`` buffers, capacity global over the batch.

    Under ``sh`` with a DTensor x, capacity stays global over the whole
    batch, as the JAX package computes it: the tokens are gathered to
    every rank, each rank routes all of them (``Shardings.local``, the
    same drops as unsharded), the buffers enter the experts with
    ``expert_spec``, and the combine runs on every rank."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    if not _sharded(sh, x):
        xe, plan, me, pe = sorted_dispatch(p, cfg, x.reshape(b * s, d))
        y = sorted_combine(_experts(p, xe), *plan, k)
        return y.reshape(b, s, d).to(x.dtype), aux_loss(me, pe, e)
    whole = P(None, None, None)
    xe, keep, buf, order, gates, me, pe = sh.local(
        lambda x, w: _flat_plan(sorted_dispatch(Local(p, w), cfg, x.reshape(b * s, d))),
        (whole, P(None), P(None), P(None), P(None), P(), P()), (whole, P()), x, p.router)
    ye = _experts(p, sh.constrain(xe, expert_spec(cfg, sh, e, None, None)))
    y = sh.local(lambda *a: sorted_combine(*a, k).reshape(b, s, d).to(x.dtype), whole,
                 (whole, P(None), P(None), P(None), P(None)), ye, keep, buf, order, gates)
    return y, aux_loss(me, pe, e)


def _flat_plan(out):
    xe, plan, me, pe = out
    return (xe, *plan, me, pe)
