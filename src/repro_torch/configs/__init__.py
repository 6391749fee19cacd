"""Architecture registry of the port: ``get_config(arch, reduced=)``.

The ten architectures of the JAX package's registry, each ``config()``
and ``reduced()`` equal field for field to the JAX package's; an unknown
id raises ``KeyError``.
"""

from __future__ import annotations

import importlib

ARCH_MODULES = {
    "llama-3.2-vision-90b": "repro_torch.configs.llama_3_2_vision_90b",
    "qwen2-0.5b": "repro_torch.configs.qwen2_0_5b",
    "qwen3-0.6b": "repro_torch.configs.qwen3_0_6b",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini_3_8b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
}

ARCH_IDS = tuple(ARCH_MODULES)


def get_config(arch: str, *, reduced: bool = False):
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; have {ARCH_IDS}")
    mod = importlib.import_module(ARCH_MODULES[arch])
    return mod.reduced() if reduced else mod.config()
