"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (kv=32) d_ff=8192
vocab=32000, ssm_state=64 — Mamba2 backbone + one shared (weight-tied)
attention+MLP block applied every 6th layer. [arXiv:2411.15242; hf]"""

import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    mlp_act="swiglu",
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    attn_every=6,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        FULL,
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        d_ff=128,
        vocab_size=256,
        ssm_state=16,
        ssm_head_dim=16,
        ssm_chunk=8,
        attn_every=2,
    )
