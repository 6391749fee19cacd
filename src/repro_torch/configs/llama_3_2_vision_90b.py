"""llama-3.2-vision-90b [vlm]: 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — a cross-attention layer every 5th layer onto a stub of
precomputed patch embeddings (``cross_kv_len`` of them; the JAX
package's ``configs/llama_3_2_vision_90b.py``)."""

from repro_torch.models.config import (FFN_DENSE, LayerSpec, MIXER_ATTN,
                                       MIXER_CROSS, ModelConfig)

PATTERN = (
    LayerSpec(MIXER_ATTN, FFN_DENSE),
    LayerSpec(MIXER_ATTN, FFN_DENSE),
    LayerSpec(MIXER_ATTN, FFN_DENSE),
    LayerSpec(MIXER_ATTN, FFN_DENSE),
    LayerSpec(MIXER_CROSS, FFN_DENSE),
)


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b",
        d_model=8192,
        n_layers=100,
        pattern=PATTERN,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab=128256,
        rope_theta=500000.0,
        cross_kv_len=4096,        # stub patch-embedding context
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b-reduced",
        d_model=64,
        n_layers=5,
        pattern=PATTERN,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=512,
        rope_theta=500000.0,
        cross_kv_len=32,
        q_chunk=16,
        k_chunk=16,
    )
