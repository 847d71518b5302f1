"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — anyres tiling backbone; vision frontend stubbed (576 patch
embeddings prepended). [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""

import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    mlp_act="swiglu",
    n_patches=576,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        FULL,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=128,
        vocab_size=256,
        n_patches=8,
    )
