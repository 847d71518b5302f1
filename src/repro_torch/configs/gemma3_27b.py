"""gemma3-27b [dense]: 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144 — 5:1 local:global attention (window 1024), 128k context,
tied embeddings. [hf:google/gemma-3-1b-pt; unverified]"""

import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_ff=21504,
    vocab_size=262144,
    mlp_act="swiglu",
    window=1024,
    global_every=6,  # 5 local : 1 global
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    """Six narrow layers, window 8, every third layer global (the JAX package's
    reduced config)."""
    return dataclasses.replace(
        FULL,
        n_layers=6,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=128,
        vocab_size=256,
        window=8,
        global_every=3,
    )
