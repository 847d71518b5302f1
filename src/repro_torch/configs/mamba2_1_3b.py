"""mamba2-1.3b [ssm]: 48L d_model=2048 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality). [arXiv:2405.21060; unverified]"""

import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        FULL,
        n_layers=2,
        d_model=64,
        vocab_size=256,
        ssm_state=16,
        ssm_head_dim=16,
        ssm_chunk=8,
    )
