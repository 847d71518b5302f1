"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]"""

import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,
    vocab_size=151936,
    mlp_act="swiglu",
    n_experts=128,
    top_k=8,
)


def reduced() -> ModelConfig:
    """Two narrow layers, 8 experts top-2 (the JAX package's reduced config)."""
    return dataclasses.replace(
        FULL,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=32,
        vocab_size=256,
        n_experts=8,
        top_k=2,
        capacity_factor=4.0,
    )
