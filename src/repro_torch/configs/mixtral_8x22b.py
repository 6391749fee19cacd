"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, sliding-window attention (the JAX
package's ``configs/mixtral_8x22b.py``)."""

from repro_torch.models.config import ModelConfig, moe_pattern


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b",
        d_model=6144,
        n_layers=56,
        pattern=moe_pattern(),
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab=32768,
        rope_theta=1000000.0,
        sliding_window=4096,
        n_experts=8,
        top_k=2,
        moe_ep=False,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b-reduced",
        d_model=64,
        n_layers=2,
        pattern=moe_pattern(),
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=512,
        sliding_window=32,
        n_experts=4,
        top_k=2,
        q_chunk=16,
        k_chunk=16,
    )
