"""phi3-mini-3.8b [dense]: 32L d_model=3072 32H (kv=32) d_ff=8192
vocab=32064 — RoPE SwiGLU, head_dim 96 (the JAX package's
``configs/phi3_mini_3_8b.py``)."""

from repro_torch.models.config import ModelConfig, dense_pattern


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b",
        d_model=3072,
        n_layers=32,
        pattern=dense_pattern(),
        n_heads=32,
        n_kv_heads=32,
        head_dim=96,
        d_ff=8192,
        vocab=32064,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b-reduced",
        d_model=64,
        n_layers=2,
        pattern=dense_pattern(),
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=160,
        vocab=512,
        q_chunk=16,
        k_chunk=16,
    )
