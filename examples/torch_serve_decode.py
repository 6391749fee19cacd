"""Batched serving demo on the PyTorch/CUDA port: prefill + greedy decode
with the cache-carrying serve path, the same program as
``examples/serve_decode.py`` on ``repro_torch.serve.engine``.  It runs on
the card (the prefill's attention through the ``flash_attention`` kernel)
unless ``--device cpu`` asks for the CPU (the kernels' plain versions).

  PYTHONPATH=src python examples/torch_serve_decode.py [--device cpu]
"""

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.models.lm import LM
from repro_torch.serve.engine import generate


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_serve_decode.py needs a CUDA card "
                         "(torch.cuda.is_available() is False); pass --device cpu "
                         "for the plain versions on the CPU")

    cfg = get_config("qwen3-0.6b", reduced=True)
    model = LM(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    B, S_PROMPT, NEW = 4, 24, 16
    prompts = torch.randint(0, cfg.vocab, (B, S_PROMPT), dtype=torch.int32,
                            generator=torch.Generator(device=dev).manual_seed(1), device=dev)

    def timed():
        t0 = time.perf_counter()
        with torch.no_grad():
            out = generate(model, prompts, max_new=NEW, max_len=S_PROMPT + NEW + 1)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    out, first = timed()
    out2, steady = timed()
    print(f"arch: {cfg.name} | batch {B}, prompt {S_PROMPT}, {NEW} new tokens on {dev}")
    print(f"first run: {first:.2f}s; steady-state: {steady:.3f}s "
          f"({B * NEW / steady:.0f} tok/s)")
    print("generated token ids (first request):", out[0].tolist())
    assert out.shape == (B, NEW) and torch.equal(out, out2)


if __name__ == "__main__":
    main()
