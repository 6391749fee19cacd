"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2 — a block of 8 layers: 7 Mamba-2
and one attention (position 4), MoE on every other layer (the JAX
package's ``configs/jamba_1_5_large_398b.py``; Mamba-2's SSD form
throughout, as there)."""

from repro_torch.models.config import (FFN_DENSE, FFN_MOE, LayerSpec,
                                       MIXER_ATTN, MIXER_MAMBA, ModelConfig,
                                       SSMConfig)

PATTERN = (
    LayerSpec(MIXER_MAMBA, FFN_DENSE),
    LayerSpec(MIXER_MAMBA, FFN_MOE),
    LayerSpec(MIXER_MAMBA, FFN_DENSE),
    LayerSpec(MIXER_MAMBA, FFN_MOE),
    LayerSpec(MIXER_ATTN, FFN_DENSE),
    LayerSpec(MIXER_MAMBA, FFN_MOE),
    LayerSpec(MIXER_MAMBA, FFN_DENSE),
    LayerSpec(MIXER_MAMBA, FFN_MOE),
)


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        d_model=8192,
        n_layers=72,
        pattern=PATTERN,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab=65536,
        n_experts=16,
        top_k=2,
        moe_ep=True,
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_kernel=4,
                      n_groups=1, chunk=128),
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b-reduced",
        d_model=64,
        n_layers=8,
        pattern=PATTERN,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=512,
        n_experts=4,
        top_k=2,
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_kernel=4,
                      n_groups=1, chunk=16),
        q_chunk=16,
        k_chunk=16,
    )
