"""minicpm3-4b [dense]: 62L d_model=2560 40H d_ff=6400 vocab=73448 — MLA
(q_lora_rank=768, kv_lora_rank=256, qk_nope=64, qk_rope=32, v_head=64;
the JAX package's ``configs/minicpm3_4b.py``).  Decode caches only the
latent and the shared RoPE key."""

from repro_torch.models.config import MLAConfig, ModelConfig, dense_pattern


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b",
        d_model=2560,
        n_layers=62,
        pattern=dense_pattern(),
        n_heads=40,
        n_kv_heads=40,
        head_dim=96,              # qk_nope + qk_rope (64 + 32)
        d_ff=6400,
        vocab=73448,
        mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                      qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64),
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b-reduced",
        d_model=64,
        n_layers=2,
        pattern=dense_pattern(),
        n_heads=5,                # keep the non-divisible head count
        n_kv_heads=5,
        head_dim=24,
        d_ff=128,
        vocab=512,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16),
        q_chunk=16,
        k_chunk=16,
    )
