"""qwen3-0.6b [dense]: 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936 — qk_norm, GQA (the JAX package's ``configs/qwen3_0_6b.py``)."""

from repro_torch.models.config import ModelConfig, dense_pattern


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b",
        d_model=1024,
        n_layers=28,
        pattern=dense_pattern(),
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=3072,
        vocab=151936,
        rope_theta=1000000.0,
        qk_norm=True,
        tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b-reduced",
        d_model=64,
        n_layers=2,
        pattern=dense_pattern(),
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=512,
        qk_norm=True,
        tie_embeddings=True,
        q_chunk=16,
        k_chunk=16,
    )
