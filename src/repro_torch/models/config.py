"""Model configuration (the port's copy of ``repro.models.config``): one
dataclass describing every architecture family in the assigned pool (dense /
MoE / SSM / hybrid / enc-dec / VLM backbones). The port serves the dense and
MoE families; the other fields are kept so configs compare field for field
with the JAX package's."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    """One architecture: widths, depth, attention/MLP/MoE/SSM options, dtype."""

    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 -> d_model // n_heads

    # -- MLP --------------------------------------------------------------
    mlp_act: str = "swiglu"  # swiglu | squared_relu | gelu

    # -- MoE ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # -- attention pattern ---------------------------------------------------
    window: int = 0  # sliding-window size for local layers (0 = full)
    global_every: int = 0  # gemma3: every Nth layer is global (rest local)
    rope_theta: float = 10_000.0

    # -- SSM (Mamba2 / SSD) -----------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    ssm_conv_width: int = 4

    # -- hybrid (zamba2): shared attention block every k layers -------------
    attn_every: int = 0

    # -- encoder-decoder (whisper) -------------------------------------------
    n_enc_layers: int = 0
    enc_frames: int = 1500  # stubbed conv frontend output length

    # -- VLM backbone (llava): stubbed vision frontend -------------------------
    n_patches: int = 0

    # -- implementation switches (perf variants; semantics identical) ---------
    moe_impl: str = "global"  # global | sharded | hinted (token-major + hints)
    attn_impl: str = "gqa"  # gqa | mha_expand (expand kv, shard fused heads)
    attn_chunk: int = 1024  # KV chunk of the online-softmax attention
    attn_remat: bool = False  # remat the chunk step (drop prob tensors in bwd)
    kv_cache_dtype: str = "model"  # model (= cfg.dtype) | int8 (quantized cache)
    window_cache: bool = False  # local layers keep a ring of `window` slots
    # (decode only; requires global_every > 0 — see LM.decode_step_windowed)

    # -- numerics / misc -----------------------------------------------------
    dtype: str = "bfloat16"
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = False
    remat: bool = True

    def __post_init__(self):
        if self.d_head == 0 and self.n_heads:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
