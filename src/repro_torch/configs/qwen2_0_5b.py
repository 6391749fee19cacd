"""qwen2-0.5b [dense]: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936 — GQA, QKV bias (the JAX package's ``configs/qwen2_0_5b.py``)."""

from repro_torch.models.config import ModelConfig, dense_pattern


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b",
        d_model=896,
        n_layers=24,
        pattern=dense_pattern(),
        n_heads=14,
        n_kv_heads=2,
        head_dim=64,
        d_ff=4864,
        vocab=151936,
        rope_theta=1000000.0,
        attn_bias=True,
        tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b-reduced",
        d_model=56,
        n_layers=2,
        pattern=dense_pattern(),
        n_heads=7,                # keep the awkward head count in the family
        n_kv_heads=1,
        head_dim=8,
        d_ff=128,
        vocab=512,
        attn_bias=True,
        tie_embeddings=True,
        q_chunk=16,
        k_chunk=16,
    )
