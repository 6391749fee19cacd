"""End-to-end training on the PyTorch/CUDA port: train a
~100M-class qwen3-family model on the synthetic pipeline with
checkpoint/restart.

The same program as ``examples/train_lm.py``, with the same flags and
defaults, on ``repro_torch.train``.  Default invocation trains a small
model for a few hundred steps; pass --d-model/--layers/--steps to scale
up.  It runs on the card (attention through the ``flash_attention``
kernel, its backward in plain PyTorch) unless ``--device cpu`` asks for
the CPU (the kernels' plain versions).

  PYTHONPATH=src python examples/torch_train_lm.py --steps 200
  PYTHONPATH=src python examples/torch_train_lm.py --steps 300   # resumes at 200
"""

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.lm import LM
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import LoopConfig, train
from repro_torch.train.step import TrainConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = get_config("qwen3-0.6b")
    cfg = dataclasses.replace(
        cfg, name="qwen3-mini", d_model=args.d_model, n_layers=args.layers,
        n_heads=max(args.d_model // 32, 1), n_kv_heads=max(args.d_model // 64, 1),
        head_dim=32, d_ff=args.d_model * 3, vocab=4096,
        q_chunk=64, k_chunk=64)
    n = sum(p.numel() for p in LM(cfg, device="meta").parameters())
    print(f"model {cfg.name}: {n/1e6:.1f}M params, "
          f"{args.batch}x{args.seq} tokens/step on {args.device}")

    tcfg = TrainConfig(
        adam=AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps),
        microbatches=args.microbatches)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch, structure=32)
    lcfg = LoopConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                      ckpt_every=50, log_every=10)
    model, opt, losses = train(cfg, tcfg, lcfg, dcfg, device=args.device)
    if losses:
        print(f"done: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
              f"over {len(losses)} steps (checkpoints in {args.ckpt_dir})")
    else:
        print(f"done: already at step {args.steps} (checkpoints in {args.ckpt_dir})")


if __name__ == "__main__":
    main()
