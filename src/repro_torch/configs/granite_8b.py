"""granite-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=49152 — llama-arch, code. [arXiv:2405.04324; hf]"""

import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=49152,
    mlp_act="swiglu",
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
