"""Model configuration (the port's copy of ``repro.models.config``): one
dataclass describing every architecture family in the assigned pool (dense /
MoE / SSM / hybrid / enc-dec / VLM backbones), its exact parameter count, and
the assigned input-shape cells. The port serves every family; configs
compare field for field with the JAX package's."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


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

    # -- derived -------------------------------------------------------------
    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM state, hybrid, or sliding-window."""
        return self.family in ("ssm", "hybrid") or (self.window > 0 and self.global_every > 0)

    def param_count(self) -> int:
        """Exact parameter count of the instantiated tree, for every family
        (tied embeddings count the table once)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        h, kv, dh = self.n_heads, self.n_kv_heads, self.d_head
        norm = 2 * d if self.norm == "layernorm" else d  # scale (+ bias)
        attn = d * h * dh + 2 * d * kv * dh + h * dh * d
        mlp = (2 if self.mlp_act == "swiglu" else 1) * d * f + f * d
        moe = d * self.n_experts + self.n_experts * mlp
        din, ds, nh = self.d_inner, self.ssm_state, self.ssm_heads
        conv_dim = din + 2 * ds
        mamba = (d * (2 * din + 2 * ds + nh) + (self.ssm_conv_width + 1) * conv_dim
                 + 3 * nh + din * d)  # in_proj, conv weight + bias, A/D/dt, out_proj

        total = v * d if self.tie_embeddings else 2 * v * d  # embed (+ lm_head)
        if self.family in ("dense", "vlm"):
            total += self.n_layers * (2 * norm + attn + mlp)
        elif self.family == "moe":
            total += self.n_layers * (2 * norm + attn + moe)
        elif self.family == "ssm":
            total += self.n_layers * (norm + mamba)
        elif self.family == "hybrid":
            total += self.n_layers * (norm + mamba)
            if self.attn_every:
                total += 2 * norm + attn + mlp  # the shared block
        elif self.family == "encdec":
            total += self.n_enc_layers * (2 * norm + attn + mlp) + norm  # encoder + its norm
            total += self.n_layers * (3 * norm + 2 * attn + mlp)
        return total + norm  # final norm

    def active_param_count(self) -> int:
        """Parameters one token touches (MoE: only its top-k experts)."""
        if self.family != "moe" or not self.n_experts:
            return self.param_count()
        per_expert = (2 if self.mlp_act == "swiglu" else 1) * self.d_model * self.d_ff + (
            self.d_ff * self.d_model)
        return self.param_count() - (self.n_experts - self.top_k) * per_expert * self.n_layers


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeConfig("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524_288, 1)

ALL_SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def applicable_shapes(cfg: ModelConfig) -> Tuple[ShapeConfig, ...]:
    """The shape cells of an architecture: ``long_500k`` only where decode
    is sub-quadratic; every architecture has a decode path."""
    shapes = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.supports_long_context:
        shapes.append(LONG_500K)
    return tuple(shapes)
