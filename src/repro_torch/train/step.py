"""Training step factory (the JAX package's ``train/step.py``): loss ->
gradients (f32 accumulation over microbatches) -> AdamW update.

Gradient accumulation splits the global batch into ``microbatches``
slices, one after another: the live activations belong to one
microbatch.  As in the JAX package, each microbatch's gradients are taken
with respect to the bf16 parameters (``torch.autograd.grad``, not
``.grad``, which would add microbatches in bf16), cast to f32 and summed
in f32, then divided by the count.

The step runs where the model lives: ``make_train_step`` asks for the
card unless ``device="cpu"``, and the step moves each batch (numpy
arrays from ``data.pipeline`` or tensors) there.

Under ``sh`` (a ``Shardings`` on a mesh, the model placed by
``launch.specs.distribute_model`` and the state by
``distribute_opt_state``), each microbatch is placed by
``launch.specs.batch_specs`` (from rank 0's values: every rank passes the
same global batch), the forward runs under ``sh``'s constraints, and each
gradient is redistributed to its moments' placement (the data-parallel
reduction; a reduce-scatter under ZeRO-1) before it is summed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.sharding import placed_like

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adam: adamw.AdamWConfig = adamw.AdamWConfig()
    microbatches: int = 1
    remat: bool = True
    aux_weight: float = 0.01


def _device(device) -> torch.device:
    """``device`` as a torch.device, a card's with its index."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("training on device='cuda' needs a CUDA card; pass "
                               "device='cpu' for the plain versions on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def to_device(batch: dict, device) -> dict:
    """A batch dict's arrays as tensors on ``device``."""
    return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
                ).to(device) for k, v in batch.items()}


def make_train_step(model_cfg, tcfg: TrainConfig, sh=None, *, device="cuda"):
    """Returns ``train_step(model, opt_state, batch) -> stats``: the model's
    parameters and ``opt_state`` are updated in place; ``stats`` holds
    ``lr``, ``grad_norm`` and ``loss`` (and ``nll``, ``aux`` with one
    microbatch), 0-d tensors on the device (DTensors under ``sh``)."""
    from repro_torch.launch.specs import batch_specs
    device = _device(device)
    sharded = sh is not None and sh.enabled

    def place(mb):
        if not sharded:
            return mb
        specs = batch_specs(model_cfg, sh, mb)
        return {k: sh.distribute(v, specs[k]) for k, v in mb.items()}

    def grads_of(model, params, batch):
        loss, metrics = lm.loss_fn(model, place(batch), sh, remat=tcfg.remat,
                                   aux_weight=tcfg.aux_weight)
        gs = torch.autograd.grad(loss, params, allow_unused=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, gs

    def train_step(model, opt_state, batch):
        if model.device != device:
            raise ValueError(f"the model is on {model.device}; this step trains on "
                             f"{device}")
        if model.cfg != model_cfg:
            raise ValueError(f"the model is {model.cfg.name}; this step trains "
                             f"{model_cfg.name}")
        batch = to_device(batch, device)
        named = dict(model.named_parameters())
        params = list(named.values())
        # the moments' placement of each gradient (themselves when unsharded)
        homes = [opt_state.mu[n] for n in named]
        m = tcfg.microbatches
        if m == 1:
            loss, metrics, gs = grads_of(model, params, batch)
            grads = [placed_like(g.to(F32), h) if g is not None else
                     torch.zeros_like(h, dtype=F32) for g, h in zip(gs, homes)]
        else:
            count = torch.full((), m, dtype=F32, device=device)
            grads = [torch.zeros_like(h, dtype=F32) for h in homes]
            loss = torch.zeros((), dtype=F32, device=device)
            for i in range(m):
                mb = {k: v.reshape(m, v.shape[0] // m, *v.shape[1:])[i]
                      for k, v in batch.items()}
                l, _, gs = grads_of(model, params, mb)
                for acc, g in zip(grads, gs):
                    if g is not None:
                        acc.add_(placed_like(g.to(F32), acc))
                loss = loss + l
                del gs
            grads = [g / count for g in grads]
            loss = loss / count
            metrics = {}
        stats = adamw.update(tcfg.adam, opt_state, named, dict(zip(named, grads)))
        return dict(stats, loss=loss, **metrics)

    return train_step


def init_state(model_cfg, tcfg: TrainConfig, seed: int = 0, *, device="cuda",
               backend: str = "kernel"):
    """(the seeded model, its AdamW state)."""
    model = lm.init_params(model_cfg, seed, device=_device(device), backend=backend)
    return model, adamw.init(tcfg.adam, model)
