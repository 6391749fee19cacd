"""musicgen-large [audio]: 48L d_model=2048 32H (kv=32) d_ff=8192
vocab=2048 — decoder-only over EnCodec tokens, the frontend a stub of
precomputed frame embeddings ``[B, S, d_model]`` (the JAX package's
``configs/musicgen_large.py``)."""

from repro_torch.models.config import ModelConfig, dense_pattern


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        d_model=2048,
        n_layers=48,
        pattern=dense_pattern(),
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab=2048,
        frontend="embeddings",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large-reduced",
        d_model=64,
        n_layers=2,
        pattern=dense_pattern(),
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab=128,
        frontend="embeddings",
        q_chunk=16,
        k_chunk=16,
    )
