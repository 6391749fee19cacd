"""Architecture registry of the port: ``get_config(arch, reduced=)``.

The serving slice ports two architectures, qwen3-0.6b (dense, GQA,
``flash_attention``) and mamba2-780m (attention-free SSD,
``ssd_chunk_scan``); every other arch of the JAX package's registry
raises ``KeyError``.
"""

from __future__ import annotations

import importlib

ARCH_MODULES = {
    "qwen3-0.6b": "repro_torch.configs.qwen3_0_6b",
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
}

ARCH_IDS = tuple(ARCH_MODULES)


def get_config(arch: str, *, reduced: bool = False):
    if arch not in ARCH_MODULES:
        raise KeyError(f"arch {arch!r} is not ported: the serving slice of the "
                       f"PyTorch port has {ARCH_IDS}")
    mod = importlib.import_module(ARCH_MODULES[arch])
    return mod.reduced() if reduced else mod.config()
