"""whisper-large-v3 [audio]: 32L enc + 32L dec, d_model=1280 20H (kv=20)
d_ff=5120 vocab=51866 — enc-dec; conv frontend STUBBED (input_specs feeds
1500 frame embeddings). [arXiv:2212.04356; unverified]"""

import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    mlp_act="gelu",
    norm="layernorm",
    n_enc_layers=32,
    enc_frames=1500,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        FULL,
        n_layers=2,
        n_enc_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        d_ff=128,
        vocab_size=256,
        enc_frames=16,
    )
