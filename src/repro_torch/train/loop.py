"""Training loop with checkpoint/restart fault tolerance (the JAX
package's ``train/loop.py``).

Restart semantics: on start, the loop resumes from the newest complete
checkpoint (parameters + optimizer + data-iterator state), so a preempted
or crashed job continues exactly where it left off — combined with the
atomic checkpointer this survives kill -9 at any point.  The loss is read
on the host once a step, as the reference's ``float(stats["loss"])``.
"""

from __future__ import annotations

import dataclasses
import time

from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.train.step import TrainConfig, init_state, make_train_step


@dataclasses.dataclass
class LoopConfig:
    steps: int = 100
    ckpt_dir: str = ""
    ckpt_every: int = 50
    log_every: int = 10
    keep: int = 2
    seed: int = 0


def train(model_cfg, tcfg: TrainConfig, lcfg: LoopConfig, dcfg: DataConfig, *,
          device="cuda", backend: str = "kernel", log=print):
    """Train ``lcfg.steps`` steps from the seeded init, or from the newest
    checkpoint in ``lcfg.ckpt_dir``; returns (model, optimizer state, the
    losses of the steps this call ran)."""
    model, opt = init_state(model_cfg, tcfg, lcfg.seed, device=device, backend=backend)
    data = SyntheticLM(dcfg)
    start_step = 0

    if lcfg.ckpt_dir:
        step0, tree, extra = ckpt.restore_latest(lcfg.ckpt_dir, (model.state_dict(), opt))
        if step0 is not None:
            state_dict, opt = tree
            model.load_state_dict(state_dict)
            data.restore(extra["data"])
            start_step = step0
            log(f"[resume] restored step {step0}")

    step_fn = make_train_step(model_cfg, tcfg, device=device)
    losses = []
    t0 = time.time()
    tokens_per_step = dcfg.global_batch * dcfg.seq_len
    for step in range(start_step, lcfg.steps):
        stats = step_fn(model, opt, next(data))
        loss = float(stats["loss"])
        losses.append(loss)
        if (step + 1) % lcfg.log_every == 0:
            dt = time.time() - t0
            tps = tokens_per_step * lcfg.log_every / max(dt, 1e-9)
            log(f"step {step+1:5d} loss {loss:.4f} "
                f"gnorm {float(stats['grad_norm']):.3f} "
                f"lr {float(stats['lr']):.2e} tok/s {tps:,.0f}")
            t0 = time.time()
        if lcfg.ckpt_dir and (step + 1) % lcfg.ckpt_every == 0:
            ckpt.save(lcfg.ckpt_dir, step + 1, (model.state_dict(), opt),
                      extra={"data": data.state()}, keep=lcfg.keep)
    if lcfg.ckpt_dir:
        ckpt.save(lcfg.ckpt_dir, lcfg.steps, (model.state_dict(), opt),
                  extra={"data": data.state()}, keep=lcfg.keep)
    return model, opt, losses
