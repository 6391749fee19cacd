"""Carry the JAX package's parameters into the port.

``from_jax_params(cfg, params_np)`` takes the JAX parameter pytree with
numpy leaves — ``groups``: one dict per pattern position, each leaf
stacked ``[repeats, ...]`` (a MoE expert stack ``[repeats, E, ...]``);
``embed`` for a token frontend; ``final_norm``; ``lm_head`` when the
embeddings are not tied or the frontend takes embeddings — and returns
the port's ``LM`` with every leaf loaded bit for bit;
``opt_state_from_jax`` carries an AdamW state across the same way.  JAX's bf16 arrays come as ``ml_dtypes.bfloat16``,
which ``torch.from_numpy`` refuses; they are reinterpreted through a
``uint16`` view (exact, no copy).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.lm import LM


def to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a, copy=True).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


def state_dict_from_jax(cfg, params_np) -> dict:
    """The port's ``state_dict`` (layer ``l`` = repetition
    ``l // len(pattern)`` of pattern position ``l % len(pattern)``)."""
    out = {}
    npat = len(cfg.pattern)
    for i, group in enumerate(params_np["groups"]):
        for name, leaf in _flatten(group):
            leaf = np.asarray(leaf)
            if leaf.shape[0] != cfg.repeats:
                raise ValueError(f"groups[{i}].{name}: leading dim {leaf.shape[0]}, "
                                 f"expected {cfg.repeats} repetitions")
            for r in range(cfg.repeats):
                out[f"layers.{r * npat + i}.{name}"] = to_torch(leaf[r])
    for name in ("embed", "final_norm", "lm_head"):
        if name in params_np:
            out[name] = to_torch(params_np[name])
    return out


def from_jax_params(cfg, params_np, *, device="cuda", backend: str = "kernel") -> LM:
    """The port's model holding the JAX parameters (strict: every port
    parameter must come from exactly one JAX leaf, and the reverse)."""
    model = LM(cfg, device=device, backend=backend)
    sd = state_dict_from_jax(cfg, params_np)
    model.load_state_dict(sd, strict=True)
    return model


def opt_state_from_jax(cfg, state_np, *, device="cuda"):
    """The port's ``AdamWState`` from the JAX package's (numpy leaves):
    the same step count, moments and f32 master weights (if any), each
    tree keyed as the port's ``state_dict``."""
    from repro_torch.optim.adamw import AdamWState

    dev = torch.device(device)

    def tree(t):
        return {k: v.to(dev) for k, v in state_dict_from_jax(cfg, t).items()}

    return AdamWState(
        step=torch.tensor(int(np.asarray(state_np.step)), dtype=torch.int32, device=dev),
        mu=tree(state_np.mu), nu=tree(state_np.nu),
        master=None if state_np.master is None else tree(state_np.master))
