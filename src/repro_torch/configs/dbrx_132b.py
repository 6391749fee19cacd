"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352, MoE 16 experts top-4 (the JAX package's
``configs/dbrx_132b.py``)."""

from repro_torch.models.config import ModelConfig, moe_pattern


def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b",
        d_model=6144,
        n_layers=40,
        pattern=moe_pattern(),
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=10752,
        vocab=100352,
        rope_theta=500000.0,
        n_experts=16,
        top_k=4,
        moe_ep=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b-reduced",
        d_model=64,
        n_layers=2,
        pattern=moe_pattern(),
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=96,
        vocab=512,
        n_experts=4,
        top_k=2,
        moe_ep=True,
        q_chunk=16,
        k_chunk=16,
    )
