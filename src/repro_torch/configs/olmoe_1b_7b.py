"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (GQA kv=16) d_ff=1024
vocab=50304, MoE 64 experts top-8. [arXiv:2409.02060; hf]"""

import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    mlp_act="swiglu",
    n_experts=64,
    top_k=8,
)


def reduced() -> ModelConfig:
    """Two narrow layers, 8 experts top-2 (the JAX package's reduced config)."""
    return dataclasses.replace(
        FULL,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        d_ff=32,
        vocab_size=256,
        n_experts=8,
        top_k=2,
        capacity_factor=4.0,
    )
