"""AdamW (the JAX package's ``optim/adamw.py``): moments in f32 or bf16,
an optional f32 master copy of the bf16 parameters, global-norm
clipping, a linear warmup into a cosine decay.

The state's leaves are dicts keyed by parameter name (the model's
``named_parameters``).  ``update`` changes the parameters and the state
in place, where the JAX package returns new ones (and donates the old).

Scalars follow the reference's f32 arithmetic: the schedule, the bias
corrections ``1 - b**step`` and the clip scale are f32 tensors on the
parameters' device, and every division has a tensor divisor, never a
Python number (PyTorch turns ``x / s`` on the card, and ``s / x``
everywhere, into a product with a reciprocal, one rounding more).

ZeRO-1: ``zero1_spec`` extends a parameter's spec with the data axes for
its optimizer state, and ``zero1_state_specs`` builds the state's spec
tree.  ``update`` takes DTensor parameters whose moments carry other
placements: each gradient is redistributed to its moments' placement
(the data-parallel reduction, a reduce-scatter under ZeRO-1), the update
runs there, and the new parameter is redistributed back to its own
placement (an all-gather) before it is written.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.sharding import P, is_dtensor, placed_like, spec_axes

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"       # "float32" | "bfloat16"
    master_weights: bool = False        # fp32 master copy of bf16 params
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor                  # int32, 0-d
    mu: dict
    nu: dict
    master: Optional[dict]


def named(params) -> dict:
    """``{name: tensor}`` of a module's parameters, or ``params`` itself."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """The Python number ``x`` as an f32 0-d tensor on ``like``'s device."""
    return torch.full((), x, dtype=F32, device=like.device)


def init(cfg: AdamWConfig, params) -> AdamWState:
    """Zero moments in ``cfg.moment_dtype`` (and f32 masters) for
    ``params``, a module or ``{name: tensor}``; step 0."""
    params = named(params)
    mdt = getattr(torch, cfg.moment_dtype)
    dev = next(iter(params.values())).device
    with torch.no_grad():
        master = ({n: p.detach().float().clone() for n, p in params.items()}
                  if cfg.master_weights else None)
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            mu={n: torch.zeros(p.shape, dtype=mdt, device=dev) for n, p in params.items()},
            nu={n: torch.zeros(p.shape, dtype=mdt, device=dev) for n, p in params.items()},
            master=master)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an int tensor), f32: a linear warmup
    over ``warmup_steps``, then a cosine from ``lr`` down to
    ``min_lr_frac * lr`` at ``total_steps``."""
    warm = torch.minimum(step.to(F32) / _f32(max(cfg.warmup_steps, 1), step),
                         _f32(1.0, step))
    prog = torch.clamp((step - cfg.warmup_steps).to(F32)
                       / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), step), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def _whole(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's full value on every rank (its shards' sums reduced over
    the mesh); a plain tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def global_norm(tensors) -> torch.Tensor:
    """The L2 norm over every element of ``tensors`` (or a dict's values),
    in f32: one sum of squares a tensor, then their sum.  A DTensor's sum
    of squares is reduced over the whole tensor, not its local shard."""
    if isinstance(tensors, dict):
        tensors = tensors.values()
    return torch.sqrt(torch.sum(torch.stack([_whole(torch.sum(x.to(F32) ** 2))
                                             for x in tensors])))


@torch.no_grad()
def update(cfg: AdamWConfig, state: AdamWState, params, grads) -> dict:
    """One AdamW step.  ``params``: a module or ``{name: tensor}``;
    ``grads``: ``{name: gradient}`` (f32, as the train step sums them).
    The parameters, moments, masters and step are updated in place;
    returns ``{"lr", "grad_norm"}`` (f32 0-d tensors)."""
    params = named(params)
    step = state.step + 1
    lr = schedule(cfg, step)
    gnorm = global_norm([grads[n] for n in params])
    scale = (torch.minimum(_f32(1.0, gnorm), _f32(cfg.grad_clip, gnorm)
                           / torch.maximum(gnorm, _f32(1e-9, gnorm)))
             if cfg.grad_clip > 0 else 1.0)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(_f32(b1, step), step.to(F32))
    bc2 = 1 - torch.pow(_f32(b2, step), step.to(F32))
    mdt = getattr(torch, cfg.moment_dtype)
    for n, p in params.items():
        mu = state.mu[n]
        g = placed_like(grads[n], mu).to(F32) * scale
        m32 = b1 * mu.to(F32) + (1 - b1) * g
        v32 = b2 * state.nu[n].to(F32) + (1 - b2) * g * g
        mhat = m32 / bc1
        vhat = v32 / bc2
        base = placed_like(state.master[n] if state.master is not None else p, mu).to(F32)
        new = base - lr * (mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * base)
        if state.master is not None:
            state.master[n] = new
        p.copy_(placed_like(new, p))
        state.mu[n] = m32.to(mdt)
        state.nu[n] = v32.to(mdt)
    state.step.copy_(step)
    return {"lr": lr, "grad_norm": gnorm}


# --------------------------------------------------------------------------
# ZeRO-1 sharding
# --------------------------------------------------------------------------


def zero1_spec(param_spec, shape, data_axes, axis_sizes) -> P:
    """Extend a parameter spec with data-axis sharding on the first
    divisible, currently-unsharded dim (optimizer-state sharding).
    No-op when the data axes already appear (FSDP-sharded params)."""
    spec = list(param_spec) if param_spec else []
    spec += [None] * (len(shape) - len(spec))
    axes = data_axes if isinstance(data_axes, tuple) else (data_axes,)
    used = {a for entry in spec for a in spec_axes(entry)}
    if used & set(axes):
        return P(*spec)     # already data-sharded (FSDP): ZeRO-1 is implied
    n = 1
    for a in axes:
        n *= axis_sizes.get(a, 1)
    for i, (dim, cur) in enumerate(zip(shape, spec)):
        if cur is None and dim % n == 0 and dim >= n:
            spec[i] = data_axes
            return P(*spec)
    return P(*spec)  # nothing divisible: stays replicated over data


def zero1_state_specs(cfg: AdamWConfig, param_specs: dict, param_shapes, sh) -> AdamWState:
    """The ``AdamWState`` spec tree from parameter specs (``{name: P}``)
    and shapes (a module, or ``{name: tensor or shape}``)."""
    shapes = named(param_shapes)
    mom = {n: zero1_spec(ps, tuple(getattr(shapes[n], "shape", shapes[n])),
                         sh.batch_axes or ("data",), sh.sizes)
           for n, ps in param_specs.items()}
    return AdamWState(step=P(), mu=mom, nu=dict(mom),
                      master=dict(mom) if cfg.master_weights else None)
