"""nemotron-4-15b [dense]: 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000 — GQA, squared-ReLU MLP. [arXiv:2402.16819; unverified]"""

import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    mlp_act="squared_relu",
)


def reduced() -> ModelConfig:
    """Two narrow layers of the same family (the JAX package's reduced config)."""
    return dataclasses.replace(
        FULL,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=128,
        vocab_size=256,
    )
