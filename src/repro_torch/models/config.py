"""Model configuration (the JAX package's ``models/config.py`` dataclasses).

A model is a repeated layer pattern: a dense transformer is
``(attn+dense,) * L``, Mamba-2 is ``(mamba,) * L``, Jamba interleaves
Mamba-2 and attention layers with dense and MoE FFNs.  Depth is
``len(pattern) * repeats``; layer ``l`` is pattern position
``l % len(pattern)`` of repetition ``l // len(pattern)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

MIXER_ATTN = "attn"
MIXER_MAMBA = "mamba"
MIXER_CROSS = "cross"    # cross-attention onto frontend embeddings (VLM)

FFN_DENSE = "dense"
FFN_MOE = "moe"
FFN_NONE = "none"


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str = MIXER_ATTN
    ffn: str = FFN_DENSE


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_dim: int = 64
    qk_rope_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    n_groups: int = 1
    chunk: int = 128

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_layers: int                       # total depth = len(pattern) * repeats
    pattern: tuple                      # tuple[LayerSpec]
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0                   # 0 -> d_model // n_heads
    d_ff: int = 0
    vocab: int = 0
    vocab_pad_to: int = 256
    rope_theta: float = 10000.0
    qk_norm: bool = False               # qwen3
    attn_bias: bool = False             # qwen2 QKV bias
    sliding_window: int = 0             # mixtral SWA
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_ep: bool = False
    moe_sorted: bool = False
    moe_bf16: bool = False
    moe_local_chunks: int = 0
    attn_bf16: bool = False             # bf16 attention scores/probs (vs f32)
    # family extras
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # frontend: "tokens" (LM) or "embeddings" (musicgen frames / VLM patches)
    frontend: str = "tokens"
    cross_kv_len: int = 0
    # chunk sizes of the JAX package's pure-jnp blocked attention; kept so
    # a config compares field for field (the port's kernel tiles itself)
    q_chunk: int = 512
    k_chunk: int = 1024
    unroll: bool = False

    def __post_init__(self):
        if self.n_layers % len(self.pattern):
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not a multiple of "
                f"pattern length {len(self.pattern)}")

    @property
    def repeats(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        pad = self.vocab_pad_to
        return -(-self.vocab // pad) * pad


def dense_pattern() -> tuple:
    return (LayerSpec(MIXER_ATTN, FFN_DENSE),)


def moe_pattern() -> tuple:
    return (LayerSpec(MIXER_ATTN, FFN_MOE),)
