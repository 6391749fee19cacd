"""mamba2-780m [ssm]: 48L d_model=1536 (attn-free) vocab=50280,
ssm_state=128 — SSD (the JAX package's ``configs/mamba2_780m.py``)."""

from repro_torch.models.config import (FFN_NONE, LayerSpec, MIXER_MAMBA,
                                       ModelConfig, SSMConfig)

PATTERN = (LayerSpec(MIXER_MAMBA, FFN_NONE),)


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m",
        d_model=1536,
        n_layers=48,
        pattern=PATTERN,
        vocab=50280,
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_kernel=4,
                      n_groups=1, chunk=128),
        tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m-reduced",
        d_model=64,
        n_layers=2,
        pattern=PATTERN,
        vocab=512,
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_kernel=4,
                      n_groups=1, chunk=16),
        tie_embeddings=True,
    )
