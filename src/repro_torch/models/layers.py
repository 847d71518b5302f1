"""Model building blocks (counterpart of the dense and global-MoE parts of
``repro.models.layers``).

Every projection routes through :func:`repro_torch.core.gemm.gemm` (the MoE
expert projections through :func:`~repro_torch.core.gemm.gemm_grouped`), so
the Stream-K++ selection layer sees every matmul and, on the card, every one
runs on the hand-written kernels. Attention stays plain torch einsum math in f32,
as in the JAX package: a chunked online softmax for prefill and a direct
softmax over the KV cache for decode. Layouts are the JAX package's: weights
``(K, N)`` for ``x @ w``, activations ``(B, S, H, dh)``, caches
``(B, S, KV, dh)`` (with ``kv_cache_dtype="int8"``: int8 values and f32
per-(token, head) scales ``(B, S, KV)``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.gemm import as_dtype, gemm, gemm_grouped
from repro_torch.core.op import Epilogue
from repro_torch.core.quant import quantize_activations
from repro_torch.dist.sharding import ArraySpec
from repro_torch.models.config import ModelConfig

Params = Dict[str, torch.Tensor]

_NEG = -1e30


def norm_spec(cfg: ModelConfig, d: Optional[int] = None) -> Dict[str, ArraySpec]:
    """Specs of one norm (scale, and bias for layernorm), f32."""
    d = d or cfg.d_model
    spec = {"scale": ArraySpec((d,), "float32", (None,), init="ones")}
    if cfg.norm == "layernorm":
        spec["bias"] = ArraySpec((d,), "float32", (None,), init="zeros")
    return spec


def norm_apply(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RMSNorm (or LayerNorm) in f32, cast back to the input dtype."""
    xf = x.to(torch.float32)
    if cfg.norm == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + 1e-6) * p["scale"] + p["bias"]
    else:
        ms = torch.square(xf).mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(ms + 1e-6) * p["scale"]
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, dh); positions: (B, S) or (S,)."""
    half = x.shape[-1] // 2
    idx = torch.arange(half, dtype=torch.float32, device=x.device)
    freqs = torch.exp(-math.log(theta) * idx / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * freqs  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


def attn_specs(cfg: ModelConfig) -> Dict[str, ArraySpec]:
    """Specs of the q/k/v/o projections, ``(K, N)`` each."""
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dt = cfg.dtype
    return {
        "wq": ArraySpec((d, h * dh), dt, ("embed", "heads")),
        "wk": ArraySpec((d, kv * dh), dt, ("embed", "kv_heads")),
        "wv": ArraySpec((d, kv * dh), dt, ("embed", "kv_heads")),
        "wo": ArraySpec((h * dh, d), dt, ("heads", "embed")),
    }


def _mask(kind: str, qpos, kpos, window: int):
    """(Sq, Sk) validity mask from position vectors."""
    if kind == "bidir":
        return torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool, device=qpos.device)
    m = qpos[:, None] >= kpos[None, :]
    if kind == "window" and window:
        m = m & (qpos[:, None] - kpos[None, :] < window)
    return m


def kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(..., head) symmetric int8 quantization over the head_dim axis,
    as ``repro``'s ``kv_quantize``: x (..., KV, dh) -> (int8 values, f32
    scales (..., KV)), scale ``max(amax, 1e-8) / 127``, rounded half to even.
    That is the per-row activation quantization over the last axis."""
    return quantize_activations(x)


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int8 cache values and their f32 scales (..., KV) back to ``dtype``."""
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


def chunked_attention(
    q: torch.Tensor,  # (B, Sq, H, dh)
    k: torch.Tensor,  # (B, Sk, KV, dh)
    v: torch.Tensor,  # (B, Sk, KV, dh)
    *,
    mask_kind: str,
    window: int = 0,
    q_positions: torch.Tensor,  # (Sq,)
    k_positions: torch.Tensor,  # (Sk,)
    chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks (a Python loop in place of
    ``lax.scan``): score memory is O(B*H*Sq*chunk). The last chunk is simply
    shorter — eager torch needs no padding to a static shape."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    groups = h // kvh
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(b, sq, kvh, groups, dh).to(torch.float32)
    m_i = torch.full((b, sq, kvh, groups), -math.inf, device=q.device)
    l_i = torch.zeros((b, sq, kvh, groups), device=q.device)
    acc = torch.zeros((b, sq, kvh, groups, dh), device=q.device)
    for c0 in range(0, k.shape[1], chunk):
        kb = k[:, c0 : c0 + chunk].to(torch.float32)
        vb = v[:, c0 : c0 + chunk].to(torch.float32)
        s = torch.einsum("bqkgd,bckd->bqkgc", qg, kb) * scale
        valid = _mask(mask_kind, q_positions, k_positions[c0 : c0 + chunk], window)
        s = torch.where(valid[None, :, None, None, :], s, _NEG)
        m_cur = torch.maximum(m_i, s.amax(dim=-1))
        p = torch.exp(s - m_cur[..., None])
        corr = torch.exp(m_i - m_cur)
        l_i = l_i * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqkgc,bckd->bqkgd", p, vb)
        m_i = m_cur
    out = acc / torch.clamp_min(l_i, 1e-30)[..., None]
    return out.reshape(b, sq, h, dh).to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # (B, Sq, H, dh)
    k_cache: torch.Tensor,  # (B, S, KV, dh)
    v_cache: torch.Tensor,
    cur_pos: torch.Tensor,  # (B,) position of the new token, or (B, Sq)
    *,
    window: int = 0,
) -> torch.Tensor:
    """Attention of Sq query tokens against the whole cache; cache rows past
    each query's position are masked."""
    b, sq, h, dh = q.shape
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    groups = h // kvh
    scale = 1.0 / math.sqrt(dh)
    qpos = cur_pos if cur_pos.dim() == 2 else cur_pos[:, None]  # (B, Sq)
    kpos = torch.arange(s, device=q.device)
    qg = q.reshape(b, sq, kvh, groups, dh).to(torch.float32)
    scores = torch.einsum("bqkgd,bskd->bqkgs", qg, k_cache.to(torch.float32)) * scale
    valid = kpos[None, None, :] <= qpos[:, :, None]  # (B, Sq, S)
    if window:
        valid = valid & (qpos[:, :, None] - kpos[None, None, :] < window)
    scores = torch.where(valid[:, :, None, None, :], scores, _NEG)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bqkgs,bskd->bqkgd", p, v_cache.to(torch.float32))
    return out.reshape(b, sq, h, dh).to(q.dtype)


def attn_apply(
    p: Params,
    x: torch.Tensor,  # (B, S, D)
    cfg: ModelConfig,
    *,
    div: Dict[str, int],
    mask_kind: str = "causal",
    window: int = 0,
    positions: Optional[torch.Tensor] = None,  # (S,) or (B, S)
    cache: Optional[Dict[str, torch.Tensor]] = None,  # k/v (B, S_max, KV, dh) [+ scales]
    cur_pos: Optional[torch.Tensor] = None,  # (B,) decode position
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """GQA attention.

    * prefill (``cache is None``): chunked attention over ``x`` itself;
      returns the fresh ``{"k", "v"}`` of the prompt for the caller's cache.
    * decode (``cache`` + ``cur_pos``, one token): the new K/V row is
      written into ``cache`` IN PLACE at ``cur_pos`` — the JAX package
      returns an updated copy; writing in place keeps one cache on the card
      instead of two — and the token attends over the whole cache. With
      ``cfg.kv_cache_dtype == "int8"`` the row is quantized into the int8
      ``k``/``v`` and the f32 ``k_scale``/``v_scale``, and the whole cache is
      dequantized to the model dtype for the attention, as ``repro`` does.
    * chunked prefill (``cache`` + ``cur_pos``, S tokens): the same, with
      the chunk's S rows written at ``cur_pos .. cur_pos + S - 1`` and each
      query row attending over the cache prefix and the chunk's causal span.
    """
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    db, dtp = div.get("batch", 1), div.get("model", 1)

    q = gemm(x, p["wq"], divisors=(db, dtp, 1), tag="attn.q").reshape(b, s, h, dh)
    knew = gemm(x, p["wk"], divisors=(db, dtp, 1), tag="attn.k").reshape(b, s, kv, dh)
    vnew = gemm(x, p["wv"], divisors=(db, dtp, 1), tag="attn.v").reshape(b, s, kv, dh)
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q = rope(q, positions, cfg.rope_theta)
    knew = rope(knew, positions, cfg.rope_theta)

    if cache is not None:
        if cur_pos is None:
            raise NotImplementedError("a cached call needs cur_pos, the first token's position")
        # the S new rows land at cur_pos .. cur_pos + S - 1 (S = 1 at decode,
        # a prompt chunk's length at chunked prefill); each query row then
        # attends over the cache prefix and the chunk's causal span, which
        # one decode_attention mask covers
        bidx = torch.arange(b, device=x.device)[:, None]
        pos_block = cur_pos[:, None] + torch.arange(s, device=x.device)[None, :]  # (B, S)
        if cfg.kv_cache_dtype == "int8":
            for key, new in (("k", knew), ("v", vnew)):
                cache[key][bidx, pos_block], cache[f"{key}_scale"][bidx, pos_block] = (
                    kv_quantize(new))
            dt = as_dtype(cfg.dtype)
            k_full = kv_dequantize(cache["k"], cache["k_scale"], dt)
            v_full = kv_dequantize(cache["v"], cache["v_scale"], dt)
        else:
            cache["k"][bidx, pos_block] = knew
            cache["v"][bidx, pos_block] = vnew
            k_full, v_full = cache["k"], cache["v"]
        out = decode_attention(q, k_full, v_full, pos_block, window=window)
        new_cache = cache
    else:
        qpos = positions if positions.dim() == 1 else positions[0]
        out = chunked_attention(
            q, knew, vnew, mask_kind=mask_kind, window=window,
            q_positions=qpos, k_positions=qpos, chunk=cfg.attn_chunk,
        )
        new_cache = {"k": knew, "v": vnew}
    y = gemm(out.reshape(b, s, h * dh), p["wo"], divisors=(db, 1, dtp), tag="attn.o")
    return y, new_cache


def mlp_specs(cfg: ModelConfig) -> Dict[str, ArraySpec]:
    """Specs of the MLP projections (plus the gate for swiglu)."""
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.dtype
    spec = {
        "w_in": ArraySpec((d, f), dt, ("embed", "ffn")),
        "w_out": ArraySpec((f, d), dt, ("ffn", "embed")),
    }
    if cfg.mlp_act == "swiglu":
        spec["w_gate"] = ArraySpec((d, f), dt, ("embed", "ffn"))
    return spec


def mlp_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, *, div: Dict[str, int]):
    """Activations ride the GEMM epilogue; swiglu fuses the gate multiply
    into the up-projection's epilogue (``mul_silu`` on the gate operand)."""
    db, dtp = div.get("batch", 1), div.get("model", 1)
    if cfg.mlp_act == "swiglu":
        gate = gemm(x, p["w_gate"], divisors=(db, dtp, 1), tag="mlp.gate")
        h = gemm(
            x,
            p["w_in"],
            divisors=(db, dtp, 1),
            tag="mlp.in",
            epilogue=Epilogue(binary="mul_silu"),
            operand=gate,
        )
    elif cfg.mlp_act == "squared_relu":
        h = gemm(x, p["w_in"], divisors=(db, dtp, 1), tag="mlp.in", epilogue="square")
    else:
        h = gemm(x, p["w_in"], divisors=(db, dtp, 1), tag="mlp.in", epilogue="gelu")
    return gemm(h, p["w_out"], divisors=(db, 1, dtp), tag="mlp.out")


def moe_specs(cfg: ModelConfig) -> Dict[str, ArraySpec]:
    """Specs of the f32 router ``(D, E)`` and the stacked expert projections
    ``(E, K, N)`` (plus the gate for swiglu)."""
    d, f, e, dt = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.dtype
    spec = {
        "router": ArraySpec((d, e), "float32", ("embed", None)),
        "w_in": ArraySpec((e, d, f), dt, ("experts", "embed", None)),
        "w_out": ArraySpec((e, f, d), dt, ("experts", None, "embed")),
    }
    if cfg.mlp_act == "swiglu":
        spec["w_gate"] = ArraySpec((e, d, f), dt, ("experts", "embed", None))
    return spec


def moe_apply(
    p: Params, x: torch.Tensor, cfg: ModelConfig, *, div: Dict[str, int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-based top-k MoE over the global token space (the JAX
    package's ``moe_impl="global"``). Returns (output, aux load-balance loss).

    Routing is deterministic and needs no sort: assignments are taken
    rank-major (every token's first choice before any second choice), a
    cumulative sum gives each assignment its position in its expert, and
    positions past the capacity land in a trash column. Every expert then
    runs at ``cap`` rows, empty or not, through three grouped GEMMs (one
    selection and, on the card, one kernel launch each)."""
    if cfg.moe_impl != "global":
        raise NotImplementedError(
            f"moe_impl={cfg.moe_impl!r} needs a device mesh or sharding hints; the port "
            "runs the global capacity dispatch only"
        )
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    xf = x.reshape(t, d)

    logits = gemm(
        xf.to(torch.float32), p["router"], divisors=(div.get("batch", 1), 1, 1),
        tag="moe.router",
    )
    probs = torch.softmax(logits, dim=-1)  # (T, E)
    gates, idx = torch.topk(probs, k, dim=-1)  # (T, k)
    gates = gates / gates.sum(dim=-1, keepdim=True)

    # capacity per expert; the min(t, 16) floor keeps tiny-T dispatch
    # (single-token decode) drop-free
    cap = max(int(cfg.capacity_factor * t * k / e), min(t, 16), 1)
    e_flat = idx.T.reshape(t * k)  # (k*T,) rank-major
    tok = torch.arange(t, device=x.device).repeat(k)
    gate_flat = gates.T.reshape(t * k)
    onehot = F.one_hot(e_flat, e)  # (kT, E)
    pos = (torch.cumsum(onehot, dim=0) * onehot - 1).amax(dim=-1)  # position in expert
    keep = pos < cap
    slot = pos.clamp_max(cap)  # cap = trash column

    # dispatch: (E, cap + 1, D); the trash column absorbs dropped tokens
    buf = torch.zeros((e, cap + 1, d), dtype=x.dtype, device=x.device)
    buf[e_flat, slot] = xf[tok]
    expert_in = buf[:, :cap]

    dg = div.get("model", 1)
    if cfg.mlp_act == "swiglu":
        gate = gemm_grouped(expert_in, p["w_gate"], g_divisor=dg, tag="moe.gate")
        h = gemm_grouped(
            expert_in,
            p["w_in"],
            g_divisor=dg,
            tag="moe.in",
            epilogue=Epilogue(binary="mul_silu"),
            operand=gate,
        )
    else:
        h = gemm_grouped(expert_in, p["w_in"], g_divisor=dg, tag="moe.in", epilogue="gelu")
    out_e = gemm_grouped(h, p["w_out"], g_divisor=dg, tag="moe.out")  # (E, cap, D)

    # combine: gather back per assignment, weight by the gate, sum the ranks
    gathered = out_e[e_flat, torch.clamp_max(slot, cap - 1)]  # (kT, D)
    w = (gate_flat * keep).to(torch.float32)
    combined = (gathered.to(torch.float32) * w[:, None]).reshape(k, t, d).sum(dim=0)

    # load-balance aux loss (Switch): E * sum_e f_e * p_e
    frac = onehot.reshape(k, t, e).sum(dim=0).to(torch.float32).mean(dim=0)
    aux = cfg.router_aux_coef * e * torch.sum(frac * probs.mean(dim=0))
    return combined.reshape(b, s, d).to(x.dtype), aux
