"""Model building blocks (counterpart of the dense, MoE, encoder and
cross-attention parts of ``repro.models.layers``).

Every projection routes through :func:`repro_torch.core.gemm.gemm` (the MoE
expert projections through :func:`~repro_torch.core.gemm.gemm_grouped`), so
the Stream-K++ selection layer sees every matmul and, on the card, every one
runs on the hand-written kernels. Attention stays plain torch einsum math in f32,
as in the JAX package: a chunked online softmax for prefill and a direct
softmax over the KV cache for decode (a sliding window masks both), or over
a local layer's ring of ``window`` slots (``attn_apply_ring``). Layouts are the JAX package's: weights
``(K, N)`` for ``x @ w``, activations ``(B, S, H, dh)``, caches
``(B, S, KV, dh)`` (with ``kv_cache_dtype="int8"``: int8 values and f32
per-(token, head) scales ``(B, S, KV)``).

Across ranks (a ranked plan, :func:`~repro_torch.dist.sharding.ranked_plan`)
every weight is this rank's shard as :meth:`ShardingPlan.spec_for` cuts it,
and each GEMM runs at its local shape with unit divisors, so its
``tag:local_mnk`` key is the one the one-rank plan's divisors give. Tensor
parallelism rides ``model``: q/k/v, the MLP's gate and up projection and
the experts are column-parallel (``heads``/``kv_heads``/``ffn``/``experts``),
``attn.o`` and ``mlp.out`` row-parallel, their f32 partials summed by an
all-reduce and cast once. FSDP
rides ``data`` (``embed``): a weight's data-sharded dims are all-gathered
just before its GEMM (the backward reduce-scatters its gradient). A kv
head count that does not divide ``model`` leaves the kv columns whole on
every rank (all-gathered, where the solver split them inside a head; a
whole kv weight whose heads the ranks read in part has its gradient summed
over ``model``), and each rank attends with the kv heads its query heads
read; a query head
count that does not divide it gathers the query columns the same way, every
rank attends with every head, and ``attn.o`` takes each rank's rows of the
heads' output. Cross-attention (the encoder-decoder) is column-parallel on
its queries and reads the cross K/V of this rank's kv heads
(:func:`project_kv`). A quantized
weight moves as its values and scales (gathered together); a row-parallel
int8-dynamic dispatch takes each row's scale over the whole row (a MAX
all-reduce over ``model``). The MoE runs expert-parallel on every
``moe_impl`` (:func:`moe_apply`).

Sequence parallelism (a training step under ``seq = "model"``, inside
:func:`~repro_torch.dist.sharding.seq_sharded`): between the blocks each
rank holds its range of the residual stream's positions, and the norms run
on it. A block's input is all-gathered along the sequence before its
column-parallel projections (:func:`seq_in`; the backward reduce-scatters
the gradient where the consumers are rank-partial, as ``sum_grad`` sums it
without the split), and each row-parallel output is reduce-scattered along
the sequence (the f32 partials, then the one cast) where it is all-reduced
without it; an output every rank computes whole keeps its range
(:func:`seq_out`).

Decode under ``kv_seq`` (:func:`~repro_torch.dist.sharding.kv_seq_split`):
each rank holds its contiguous range of the cache's positions, for every kv
head where the rules keep them whole. The new row is written by the rank
that owns its position alone, each rank attends over its own positions, and
the partial softmaxes combine across the ``kv_seq`` axes in f32: a max
all-reduce, then one sum all-reduce of the rescaled denominators and
outputs (:func:`combine_partials`). Where ``kv_seq`` rides ``model`` and
the query heads split over it, the ranks all-gather ``q`` first, attend
with every head, and each keeps its heads' output for ``attn.o``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.gemm import as_dtype, gemm, gemm_grouped
from repro_torch.core.op import Epilogue
from repro_torch.core.quant import QuantizedTensor, is_quantized, quantize_activations
from repro_torch.dist.collectives import (
    all_gather,
    all_reduce,
    all_reduce_axes,
    all_reduce_max,
    mesh_axis,
    raw_all_gather,
    reduce_scatter,
    split,
    sum_grad,
)
from repro_torch.dist.sharding import (
    ArraySpec,
    KVSeqSplit,
    axes_of,
    batch_axes,
    constrain,
    current_plan,
    kv_seq_split,
    ranked_plan,
    row_axes,
    seq_split,
)
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


def _chunk_step(m_i, l_i, acc, qg, kb, vb, valid, scale):
    """One KV chunk of the online softmax: the running max ``m_i``, sum
    ``l_i`` and output ``acc`` after the chunk ``kb``/``vb`` (B, C, KV, dh)
    under ``valid`` (Sq, C)."""
    s = torch.einsum("bqkgd,bckd->bqkgc", qg, kb.to(torch.float32)) * scale
    s = torch.where(valid[None, :, None, None, :], s, _NEG)
    m_cur = torch.maximum(m_i, s.amax(dim=-1))
    p = torch.exp(s - m_cur[..., None])
    corr = torch.exp(m_i - m_cur)
    l_cur = l_i * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum("bqkgc,bckd->bqkgd", p, vb.to(torch.float32))
    return m_cur, l_cur, acc


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
    remat_step: bool = False,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks (a Python loop in place of
    ``lax.scan``): score memory is O(B*H*Sq*chunk). The last chunk is simply
    shorter — eager torch needs no padding to a static shape. With
    ``remat_step`` (``cfg.attn_remat``), when grad is on, each chunk step is
    checkpointed (``torch.utils.checkpoint``, as ``repro``'s
    ``jax.checkpoint(step)``): the backward recomputes a chunk's scores and
    probabilities instead of keeping them for every chunk."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    groups = h // kvh
    scale = 1.0 / math.sqrt(dh)
    remat = remat_step and torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    qg = q.reshape(b, sq, kvh, groups, dh).to(torch.float32)
    m_i = torch.full((b, sq, kvh, groups), -math.inf, device=q.device)
    l_i = torch.zeros((b, sq, kvh, groups), device=q.device)
    acc = torch.zeros((b, sq, kvh, groups, dh), device=q.device)
    for c0 in range(0, k.shape[1], chunk):
        kb, vb = k[:, c0 : c0 + chunk], v[:, c0 : c0 + chunk]
        valid = _mask(mask_kind, q_positions, k_positions[c0 : c0 + chunk], window)
        if remat:
            m_i, l_i, acc = checkpoint(_chunk_step, m_i, l_i, acc, qg, kb, vb, valid, scale,
                                       use_reentrant=False)
        else:
            m_i, l_i, acc = _chunk_step(m_i, l_i, acc, qg, kb, vb, valid, scale)
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


def softmax_partials(qg, k, v, valid, scale):
    """One rank's share of a softmax attention over its keys ``k``/``v``
    (B, S, KV, dh) under ``valid`` (B, Sq, S), in f32: (the max score m,
    the sum l of exp(score - m), the sum acc of exp(score - m) v). A query
    row with no valid key here gets the finite ``_NEG`` as its max, which
    the combine weighs by exp(_NEG - max) = 0."""
    s = torch.einsum("bqkgd,bskd->bqkgs", qg, k.to(torch.float32)) * scale
    s = torch.where(valid[:, :, None, None, :], s, _NEG)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    return m, p.sum(dim=-1), torch.einsum("bqkgs,bskd->bqkgd", p, v.to(torch.float32))


def combine_partials(m, l, acc, axes) -> torch.Tensor:
    """The attention output from every rank's :func:`softmax_partials` over
    the mesh ``axes`` (the ``kv_seq`` axes), in f32: the max all-reduced,
    then the denominators and outputs rescaled to it and summed in one
    all-reduce."""
    top = all_reduce_max(m, axes)
    corr = torch.exp(m - top)
    packed = torch.cat([(l * corr)[..., None], acc * corr[..., None]], dim=-1)
    packed = all_reduce_axes(packed, axes)
    return packed[..., 1:] / packed[..., :1]


def decode_attention_ring(
    q: torch.Tensor,  # (B, 1, H, dh)
    k_ring: torch.Tensor,  # (B, W, KV, dh): slot j holds the most recent
    v_ring: torch.Tensor,  # position p with p % W == j
    cur_pos: torch.Tensor,  # (B,)
    window: int,
) -> torch.Tensor:
    """One token's attention over a ring-buffer window cache: O(W) reads in
    place of O(S), the windowed-cache decode of local-attention layers."""
    b, _, h, dh = q.shape
    w, kvh = k_ring.shape[1], k_ring.shape[2]
    groups = h // kvh
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(b, kvh, groups, dh).to(torch.float32)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k_ring.to(torch.float32)) * scale
    # slot j holds position cur - ((cur - j) mod W); negative: not written yet
    slots = torch.arange(w, device=q.device)[None, :]
    kpos = cur_pos[:, None] - torch.remainder(cur_pos[:, None] - slots, w)
    valid = (kpos >= 0) & (cur_pos[:, None] - kpos < window)
    scores = torch.where(valid[:, None, None, :], scores, _NEG)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_ring.to(torch.float32))
    return out.reshape(b, 1, h, dh).to(q.dtype)


def attn_apply_ring(
    p: Params,
    x: torch.Tensor,  # (B, 1, D)
    cfg: ModelConfig,
    *,
    div: Dict[str, int],
    cache: Dict[str, torch.Tensor],  # k/v rings (B, W, KV, dh)
    cur_pos: torch.Tensor,  # (B,)
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """A local-attention layer's decode step against its ring cache: the new
    K/V row is written IN PLACE at slot ``cur_pos % W`` (``repro`` returns
    an updated copy), then the token attends over the ring."""
    b = x.shape[0]
    w = cache["k"].shape[1]

    q, knew, vnew, pick = _project_qkv(p, x, cfg, div)
    q = rope(q, cur_pos[:, None], cfg.rope_theta)
    knew = rope(knew, cur_pos[:, None], cfg.rope_theta)

    bidx = torch.arange(b, device=x.device)
    slot = torch.remainder(cur_pos, w)
    cache["k"][bidx, slot] = knew[:, 0]
    cache["v"][bidx, slot] = vnew[:, 0]
    out = decode_attention_ring(q, pick(cache["k"]), pick(cache["v"]), cur_pos, cfg.window)
    return _project_o(p, out.reshape(b, 1, -1), cfg, div), cache


def gather_weight(w, parts):
    """FSDP: ``w`` (this rank's shard, partition entries ``parts``) with
    every dim that rides an axis other than ``model`` all-gathered (the
    backward reduce-scatters the gradient). A quantized weight gathers its
    values by ``parts`` and its scales by ``parts`` without the K entry."""
    if is_quantized(w):
        values = gather_weight(w.values, parts)
        scales = gather_weight(w.scales, parts[:-2] + parts[-1:])
        k = w.k * values.shape[-2] // w.values.shape[-2] if w.bits == 4 else None
        return QuantizedTensor(values, scales, bits=w.bits, act_bits=w.act_bits, k=k)
    for dim, part in enumerate(parts):
        for axis in reversed(axes_of(part)):  # innermost axis first
            if axis != "model":
                w = all_gather(w, axis, dim)
    return w


def _on_model(parts, dim: int) -> bool:
    return "model" in axes_of(parts[dim])


def _ranked_weight(p: Params, key: str, spec: ArraySpec, plan):
    """(the weight ``p[key]`` gathered over its FSDP axes, its entries)."""
    parts = plan.spec_for(spec)
    return gather_weight(p[key], parts), parts


def _kv_pick(cfg: ModelConfig, plan, hl: int, aligned: bool):
    """Selects, from a tensor of this rank's kv heads (..., KVc, dh), the kv
    heads its ``hl`` query heads read: all of them where the kv heads split
    with the query heads (``aligned``) or every query head is local; else,
    from all ``kv`` heads, a slice when the local query heads map onto a
    run of kv heads in equal groups, or one kv row per query head."""
    if aligned or hl == cfg.n_heads:
        return _identity
    j = plan.mesh.coords.get("model", 0)
    g = cfg.n_heads // cfg.n_kv_heads
    heads = [(j * hl + t) // g for t in range(hl)]
    lo, n = heads[0], heads[-1] - heads[0] + 1
    if hl % n == 0 and heads == [lo + t // (hl // n) for t in range(hl)]:
        return lambda t: t[..., lo:lo + n, :]
    index = torch.tensor(heads)
    return lambda t: t.index_select(-2, index.to(t.device))


def _identity(t):
    return t


def kv_aligned(cfg: ModelConfig, plan) -> bool:
    """Whether the kv heads split over ``model`` with their columns, each
    rank holding ``n_kv_heads / model`` whole heads (else every rank holds
    all of them)."""
    tp = plan.mesh.shape.get("model", 1)
    parts = plan.spec_for(attn_specs(cfg)["wk"])
    return _on_model(parts, 1) and cfg.n_kv_heads % tp == 0


def _ranked_q(p: Params, x: torch.Tensor, cfg: ModelConfig, plan) -> torch.Tensor:
    """The query projection across ranks, q (B, S, Hq, dh): column-parallel
    on this rank's heads; where the plan splits the columns inside a head
    (query heads that do not divide the model axis), every rank gathers all
    of them and attends with every head. ``x`` is the caller's: where the
    columns split it must already carry :func:`sum_grad`."""
    b, s, _ = x.shape
    wq, pq = _ranked_weight(p, "wq", attn_specs(cfg)["wq"], plan)
    q = gemm(x, wq, tag="attn.q")
    if _on_model(pq, 1) and cfg.n_heads % plan.mesh.shape["model"]:
        q = all_gather(q, "model", -1)
    return q.reshape(b, s, -1, cfg.d_head)


def _ranked_kv(p: Params, x: torch.Tensor, cfg: ModelConfig, plan, q_split: bool,
               prefix: str = "attn"):
    """The k and v projections of ``x`` across ranks, (k, v (B, S, KVc,
    dh)): this rank's kv heads where they split with their columns
    (:func:`kv_aligned`), else all of them. ``prefix`` names the tags
    (``attn`` or the cross-attention's ``xattn``)."""
    b, s, _ = x.shape
    specs = attn_specs(cfg)
    wk, pk = _ranked_weight(p, "wk", specs["wk"], plan)
    wv, _ = _ranked_weight(p, "wv", specs["wv"], plan)
    k_split = _on_model(pk, 1)
    if q_split and not k_split:
        # whole kv weights, of which each rank reads some heads: the
        # weights' gradients are summed (the input's is, by the caller)
        wk, wv = sum_grad(wk, "model"), sum_grad(wv, "model")
    k = gemm(x, wk, tag=f"{prefix}.k")
    v = gemm(x, wv, tag=f"{prefix}.v")
    if k_split and not kv_aligned(cfg, plan):
        # the solver split the kv columns inside a head: every rank takes all
        k, v = all_gather(k, "model", -1), all_gather(v, "model", -1)
    return k.reshape(b, s, -1, cfg.d_head), v.reshape(b, s, -1, cfg.d_head)


def _project_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig, div: Dict[str, int]):
    """The q, k and v projections of ``x`` (B, S, D): (q (B, S, Hq, dh), k,
    v (B, S, KVc, dh), pick). On one rank Hq = H and KVc = KV. Across ranks
    Hq is this rank's query heads (all of them where the heads do not
    divide the model axis), KVc its kv heads where they divide it and else
    all of them, and ``pick`` selects from a (..., KVc, dh) tensor (the
    fresh rows or the cache) the kv heads the local query heads read
    (module doc)."""
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    plan = ranked_plan()
    if plan is None:
        db, dtp = div.get("batch", 1), div.get("model", 1)
        q = gemm(x, p["wq"], divisors=(db, dtp, 1), tag="attn.q").reshape(b, s, h, dh)
        k = gemm(x, p["wk"], divisors=(db, dtp, 1), tag="attn.k").reshape(b, s, kv, dh)
        v = gemm(x, p["wv"], divisors=(db, dtp, 1), tag="attn.v").reshape(b, s, kv, dh)
        return q, k, v, _identity
    q_split = _on_model(plan.spec_for(attn_specs(cfg)["wq"]), 1)
    # the rank-partial consumers of a replicated input sum its gradient
    xin = seq_in(x, q_split)
    q = _ranked_q(p, xin, cfg, plan)
    # kv columns split only where the query columns do (kv * dh divides h * dh)
    k, v = _ranked_kv(p, xin, cfg, plan, q_split)
    return q, k, v, _kv_pick(cfg, plan, q.shape[2], kv_aligned(cfg, plan))


def project_kv(p: Params, x: torch.Tensor, cfg: ModelConfig, div: Dict[str, int],
               prefix: str = "xattn") -> Tuple[torch.Tensor, torch.Tensor]:
    """The k and v projections alone, (k, v (B, S, KVc, dh)): the
    cross-attention's K/V of the encoder's output. On one rank every kv
    head; across ranks this rank's kv heads where they divide the model
    axis, else all of them (the cross cache's layout)."""
    b, s, _ = x.shape
    plan = ranked_plan()
    if plan is None:
        db, dtp = div.get("batch", 1), div.get("model", 1)
        return tuple(gemm(x, p[f"w{key}"], divisors=(db, dtp, 1), tag=f"{prefix}.{key}")
                     .reshape(b, s, cfg.n_kv_heads, cfg.d_head) for key in "kv")
    k_split = _on_model(plan.spec_for(attn_specs(cfg)["wk"]), 1)
    q_split = _on_model(plan.spec_for(attn_specs(cfg)["wq"]), 1)
    # the encoder's output is whole on every rank (also in a
    # sequence-parallel step); its consumers here are rank-partial where
    # the kv columns split or the ranks read some heads of whole ones
    xin = sum_grad(x, "model") if k_split or q_split else x
    return _ranked_kv(p, xin, cfg, plan, q_split, prefix)


def _project_q(p: Params, x: torch.Tensor, cfg: ModelConfig, div: Dict[str, int]):
    """The cross-attention's query projection (B, S, Hq, dh): this rank's
    heads across ranks (:func:`_ranked_q`)."""
    b, s, _ = x.shape
    plan = ranked_plan()
    if plan is None:
        db, dtp = div.get("batch", 1), div.get("model", 1)
        return gemm(x, p["wq"], divisors=(db, dtp, 1), tag="attn.q").reshape(
            b, s, cfg.n_heads, cfg.d_head)
    split = _on_model(plan.spec_for(attn_specs(cfg)["wq"]), 1)
    return _ranked_q(p, seq_in(x, split), cfg, plan)


def _project_o(p: Params, out: torch.Tensor, cfg: ModelConfig, div: Dict[str, int]):
    """The output projection of the attention ``out`` (B, S, Hq * dh);
    across ranks row-parallel, summed over ``model``. Where every rank
    attended with every head (:func:`_ranked_q`), it takes the columns of
    ``out`` that its rows of ``wo`` read."""
    plan = ranked_plan()
    if plan is None:
        db, dtp = div.get("batch", 1), div.get("model", 1)
        return gemm(out, p["wo"], divisors=(db, 1, dtp), tag="attn.o")
    wo, po = _ranked_weight(p, "wo", attn_specs(cfg)["wo"], plan)
    if not _on_model(po, 0):
        return seq_out(gemm(out, wo, tag="attn.o"))
    rows = wo.shape[0]
    if out.shape[-1] != rows:
        out = out.narrow(-1, plan.mesh.coords["model"] * rows, rows)
    return _row_parallel(out, wo, "attn.o")


def _row_parallel(x: torch.Tensor, w, tag: str) -> torch.Tensor:
    """A row-parallel GEMM of ``x`` (B, S, K/model): K split over
    ``model``, the partials summed before one cast (``gemm``'s ``k_axis``),
    as GSPMD all-reduces the dot's f32 (or, with int8 activations, int32)
    result before the cast; under sequence parallelism reduce-scattered
    along the sequence instead (module doc)."""
    return gemm(x, w, tag=tag, k_axis="model", k_scatter=1 if seq_split() else None)


def seq_in(x: torch.Tensor, partial: bool) -> torch.Tensor:
    """The input (B, S, D) of a block's projections across ranks. Under
    sequence parallelism ``x`` is this rank's range of positions, and the
    result all of them, gathered over ``model``: the backward reduce-scatters
    the gradient where the consumers are rank-partial (``partial``), else
    keeps this rank's slice of it (every rank's is whole). Without it ``x``
    itself, its gradient summed over ``model`` where the consumers are
    rank-partial (:func:`~repro_torch.dist.collectives.sum_grad`)."""
    if seq_split():
        return all_gather(x, "model", 1, grad="reduce_scatter" if partial else "slice")
    return sum_grad(x, "model") if partial else x


def seq_out(y: torch.Tensor) -> torch.Tensor:
    """A block's output (B, S, D) that every rank computed whole: under
    sequence parallelism this rank's range of positions (the backward
    gathers the ranks' gradients), else ``y``."""
    return split(y, "model", 1) if seq_split() else y


def sum_model(y: torch.Tensor) -> torch.Tensor:
    """The sum over ``model`` of a rank-partial block output (B, S, D):
    reduce-scattered along the sequence under sequence parallelism, else
    all-reduced."""
    return reduce_scatter(y, "model", 1) if seq_split() else all_reduce(y, "model")


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
    kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # cross-attention k, v
    use_rope: bool = True,
    kv_split: Optional[KVSeqSplit] = None,  # the split of kv_override's positions
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """GQA attention (RoPE on q and k unless ``use_rope=False``).

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
    * cross-attention (``kv_override``, the encoder's (k, v), each
      (B, Sk, KV, dh)): only the query projection runs, and every query row
      attends over all of ``k``/``v`` (the ``bidir`` mask); nothing is
      cached, and the second return value is None. With ``kv_split`` the
      (k, v) are this rank's range of the frames, and the ranks' partial
      softmaxes combine.

    Across ranks a cache whose positions split over the ``kv_seq`` axes
    (:func:`~repro_torch.dist.sharding.kv_seq_split`) is this rank's range
    of them (module doc).
    """
    b = x.shape[0]
    if kv_override is not None:
        if cache is not None:
            raise ValueError("cross-attention reads kv_override and keeps no cache")
        q = _project_q(p, x, cfg, div)
        s = q.shape[1]  # the whole sequence (a sequence-parallel x is a range of it)
        if positions is None:
            positions = torch.arange(s, device=x.device)
        if use_rope:
            q = rope(q, positions, cfg.rope_theta)
        k_full, v_full = kv_override
        plan = ranked_plan()
        if kv_split is not None:
            valid = torch.ones((b, s, k_full.shape[1]), dtype=torch.bool, device=x.device)
            out = _split_attention(q, k_full, v_full, valid, kv_split, cfg, plan)
            return _project_o(p, out.reshape(b, s, -1), cfg, div), None
        if plan is not None:  # this rank's kv heads (project_kv), or all of them
            pick = _kv_pick(cfg, plan, q.shape[2], kv_aligned(cfg, plan))
            k_full, v_full = pick(k_full), pick(v_full)
        out = chunked_attention(
            q, k_full, v_full, mask_kind="bidir", q_positions=torch.arange(s, device=x.device),
            k_positions=torch.arange(k_full.shape[1], device=x.device), chunk=cfg.attn_chunk,
            remat_step=cfg.attn_remat,
        )
        return _project_o(p, out.reshape(b, s, -1), cfg, div), None
    q, knew, vnew, pick = _project_qkv(p, x, cfg, div)
    s = q.shape[1]  # the whole sequence (a sequence-parallel x is a range of it)
    if positions is None:
        positions = torch.arange(s, device=x.device)
    if use_rope:
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
        plan = ranked_plan()
        split_ = None if plan is None else kv_seq_split(
            plan, b * math.prod(plan.mesh.shape[a] for a in row_axes(plan)))
        if split_ is not None and knew.shape[2] != cache["k"].shape[2]:
            raise ValueError(
                f"the cache holds {cache['k'].shape[2]} kv heads a rank and the projection "
                f"{knew.shape[2]}: a plan whose kv_seq rides 'model' keeps the kv heads whole "
                "(kv_heads=None)")
        local_len = cache["k"].shape[1]
        local = pos_block - (0 if split_ is None else split_.offset(local_len))
        # each row is written by the rank that holds its position
        inside = None if split_ is None else (local >= 0) & (local < local_len)
        if cfg.kv_cache_dtype == "int8":
            for key, new in (("k", knew), ("v", vnew)):
                values, scales = kv_quantize(new)
                _write_rows(cache[key], bidx, local, inside, values)
                _write_rows(cache[f"{key}_scale"], bidx, local, inside, scales)
            dt = as_dtype(cfg.dtype)
            k_full = kv_dequantize(cache["k"], cache["k_scale"], dt)
            v_full = kv_dequantize(cache["v"], cache["v_scale"], dt)
        else:
            _write_rows(cache["k"], bidx, local, inside, knew)
            _write_rows(cache["v"], bidx, local, inside, vnew)
            k_full, v_full = cache["k"], cache["v"]
        if split_ is None:
            out = decode_attention(q, pick(k_full), pick(v_full), pos_block, window=window)
        else:
            kpos = torch.arange(local_len, device=x.device) + split_.offset(local_len)
            valid = kpos[None, None, :] <= pos_block[:, :, None]
            if window:
                valid = valid & (pos_block[:, :, None] - kpos[None, None, :] < window)
            out = _split_attention(q, k_full, v_full, valid, split_, cfg, plan, pick)
        new_cache = cache
    else:
        qpos = positions if positions.dim() == 1 else positions[0]
        out = chunked_attention(
            q, pick(knew), pick(vnew), mask_kind=mask_kind, window=window,
            q_positions=qpos, k_positions=qpos, chunk=cfg.attn_chunk,
            remat_step=cfg.attn_remat,
        )
        new_cache = {"k": knew, "v": vnew}
    return _project_o(p, out.reshape(b, s, -1), cfg, div), new_cache


def _write_rows(leaf: torch.Tensor, bidx, local, inside, new: torch.Tensor) -> None:
    """Write ``new`` (B, S, ...) into the cache leaf (B, S_local, ...) in
    place at rows ``local`` (B, S) of its batch rows ``bidx``: all of them,
    or, with ``inside`` (B, S), those this rank holds (a one-token step
    without a data-dependent shape, so a meta trace runs it too)."""
    if inside is None:
        leaf[bidx, local] = new
    elif local.shape[1] == 1:
        at = local.clamp(0, leaf.shape[1] - 1)
        mask = inside.reshape(inside.shape + (1,) * (new.dim() - 2))
        leaf[bidx, at] = torch.where(mask, new.to(leaf.dtype), leaf[bidx, at])
    else:
        rows, cols = torch.nonzero(inside, as_tuple=True)
        leaf[rows, local[rows, cols]] = new[rows, cols].to(leaf.dtype)


def _split_attention(q, k, v, valid, split_: KVSeqSplit, cfg: ModelConfig, plan,
                     pick=_identity) -> torch.Tensor:
    """``q`` (B, Sq, Hq, dh) against this rank's range of the keys ``k``/``v``
    (B, S_local, KVc, dh) under ``valid`` (B, Sq, S_local), combined across
    the ``kv_seq`` axes (module doc); returns (B, Sq, Hq, dh). Where those
    ride ``model`` and the query heads split over it, ``q`` is all-gathered
    over ``model`` first and this rank's heads are kept of the output."""
    b, sq, hq, dh = q.shape
    gather = "model" in split_.axes and hq < cfg.n_heads
    if gather:
        q = all_gather(q, "model", 2)
        pick = _kv_pick(cfg, plan, cfg.n_heads, kv_aligned(cfg, plan))
    k, v = pick(k), pick(v)
    h, kvh = q.shape[2], k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, dh).to(torch.float32)
    parts = softmax_partials(qg, k, v, valid, 1.0 / math.sqrt(dh))
    out = combine_partials(*parts, split_.axes).reshape(b, sq, h, dh).to(q.dtype)
    if gather:
        out = out.narrow(2, plan.mesh.coords["model"] * hq, hq)
    return out


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
    into the up-projection's epilogue (``mul_silu`` on the gate operand).
    Across ranks the up-projections are column-parallel over ``ffn`` and
    ``mlp.out`` row-parallel, summed over ``model`` (module doc)."""
    plan = ranked_plan()
    split = False
    if plan is None:
        db, dtp = div.get("batch", 1), div.get("model", 1)
        w, up, down = p, (db, dtp, 1), (db, 1, dtp)
    else:
        specs = mlp_specs(cfg)
        w, parts = {}, {}
        for key in specs:
            w[key], parts[key] = _ranked_weight(p, key, specs[key], plan)
        split = _on_model(parts["w_in"], 1)
        x = seq_in(x, split)
        up = down = (1, 1, 1)
    if cfg.mlp_act == "swiglu":
        gate = gemm(x, w["w_gate"], divisors=up, tag="mlp.gate")
        h = gemm(
            x,
            w["w_in"],
            divisors=up,
            tag="mlp.in",
            epilogue=Epilogue(binary="mul_silu"),
            operand=gate,
        )
    elif cfg.mlp_act == "squared_relu":
        h = gemm(x, w["w_in"], divisors=up, tag="mlp.in", epilogue="square")
    else:
        h = gemm(x, w["w_in"], divisors=up, tag="mlp.in", epilogue="gelu")
    if split:
        return _row_parallel(h, w["w_out"], "mlp.out")
    out = gemm(h, w["w_out"], divisors=down, tag="mlp.out")
    return out if plan is None else seq_out(out)


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
    """Capacity-based top-k MoE. Returns (output, aux load-balance loss).

    ``cfg.moe_impl`` picks the dispatch, as in ``repro``: ``global`` routes
    over the global token space rank-major (every token's first choice
    before any second choice); ``hinted`` routes token-major (a token's
    choices in turn, GShard's priority) with the sharding hints of
    ``repro``'s perf variant; ``sharded`` routes each of ``div["batch"]``
    token groups into its own capacity (:func:`moe_apply_sharded`);
    ``shard_map``/``shard_map_bf16`` run the per-rank expert-parallel body
    under a plan (:func:`moe_apply_shard_map`) and the capacity dispatch
    without one, or on quantized experts.

    Routing is deterministic and needs no sort: a cumulative sum gives each
    assignment its position in its expert, and positions past the capacity
    land in a trash column. Every expert then runs at ``cap`` rows, empty or
    not, through three grouped GEMMs (one selection and, on the card, one
    kernel launch each).

    Across ranks every variant runs expert-parallel: each rank routes its
    rows with the f32 router, dispatches the assignments to its own
    ``E / model`` experts (weights gathered over their FSDP axes; B5 at
    G = E / model, unit divisors), and the combined output is summed over
    ``model``. Where the rows split over the data axes (:func:`row_axes`),
    ``global`` and ``hinted`` exchange each rank's per-(choice, expert)
    counts over them, so every assignment takes the position the whole
    batch's order gives it, at the capacity of the global token count;
    ``sharded`` routes each data rank's rows as one group. Where the step
    differentiates, the aux loss's means are the whole batch's, as one
    device takes them (:func:`_batch_means`)."""
    impl = cfg.moe_impl
    if impl in ("shard_map", "shard_map_bf16"):
        # quantized expert weights take the capacity dispatch under a plan too,
        # as in repro (a rank-pinned layout cannot describe values + scales)
        if current_plan() is not None and not is_quantized(p["w_in"]):
            return moe_apply_shard_map(p, x, cfg, div=div)
        impl = "global"
    elif impl == "sharded":
        return moe_apply_sharded(p, x, cfg, div=div)
    elif impl not in ("global", "hinted"):
        raise ValueError(f"unknown moe_impl {cfg.moe_impl!r}")
    hinted = impl == "hinted"
    plan = ranked_plan()
    w, e_loc, j, split, dg = _moe_weights(p, cfg, plan, div)
    rows = () if plan is None else row_axes(plan)
    if plan is not None:
        x = seq_in(x, False)  # every rank routes every token (the sums below)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    tl = b * s  # this rank's tokens
    t = tl * math.prod(plan.mesh.shape[a] for a in rows) if rows else tl
    xf = x.reshape(tl, d)
    if hinted:
        xf = constrain(xf, "batch", None)

    logits = gemm(
        xf.to(torch.float32), w["router"], divisors=(div.get("batch", 1), 1, 1),
        tag="moe.router",
    )
    probs = torch.softmax(logits, dim=-1)  # (T, E)
    gates, idx = torch.topk(probs, k, dim=-1)  # (T, k)
    gates = gates / gates.sum(dim=-1, keepdim=True)

    # capacity per expert; the min(t, 16) floor keeps tiny-T dispatch
    # (single-token decode) drop-free
    cap = max(int(cfg.capacity_factor * t * k / e), min(t, 16), 1)
    if hinted:
        # token-major: the flattened (T*k,) axis keeps T's sharding
        e_flat = constrain(idx.reshape(tl * k), "batch")
        tok = torch.arange(tl, device=x.device).repeat_interleave(k)
        gate_flat = gates.reshape(tl * k)
    else:
        e_flat = idx.T.reshape(tl * k)  # (k*T,) rank-major
        tok = torch.arange(tl, device=x.device).repeat(k)
        gate_flat = gates.T.reshape(tl * k)
    onehot = F.one_hot(e_flat, e)  # (kT, E)
    pos = (torch.cumsum(onehot, dim=0) * onehot - 1).amax(dim=-1)  # position in expert
    if rows:
        pos = pos + _row_offsets(onehot, e_flat, hinted, k, tl, rows, plan)
    keep = pos < cap
    slot = pos.clamp_max(cap)  # cap = trash column

    # dispatch into (E_local, cap + 1, D) (the trash column absorbs dropped
    # tokens and, across ranks, other ranks' experts), the experts, and the
    # gather back per assignment
    src = sum_grad(xf, "model") if split else xf
    gathered, mine = _expert_dispatch(w, src, tok, e_flat, slot, cap, e_loc, j, cfg, dg,
                                      hint=hinted and plan is None)
    # combine: weight each assignment by its gate, sum the choices
    gate_flat = sum_grad(gate_flat, "model") if split else gate_flat
    wts = (gate_flat * keep * mine).to(torch.float32)
    if hinted:
        gathered = constrain(gathered, "batch", None)
        combined = (gathered.to(torch.float32) * wts[:, None]).reshape(tl, k, d).sum(dim=1)
        frac = onehot.reshape(tl, k, e).sum(dim=1)
    else:
        combined = (gathered.to(torch.float32) * wts[:, None]).reshape(k, tl, d).sum(dim=0)
        frac = onehot.reshape(k, tl, e).sum(dim=0)
    combined = combined.reshape(b, s, d)
    if split:
        combined = sum_model(combined)

    # load-balance aux loss (Switch): E * sum_e f_e * p_e
    frac, mean_p = _batch_means(frac.to(torch.float32).mean(dim=0), probs.mean(dim=0), rows)
    aux = cfg.router_aux_coef * e * torch.sum(frac * mean_p)
    return combined.to(x.dtype), aux


def _batch_means(frac, mean_p, rows):
    """The aux loss's routed fractions and mean probabilities over the whole
    batch where the rows split over the data axes ``rows`` and the step
    differentiates (every rank holds equally many rows, so the mean of the
    ranks' means), as one device takes them; as they are otherwise (a
    serving step reads no aux loss). Each data rank's loss holds a share of
    the batch's aux loss (``LM.loss_fn``), so the backward sums the ranks'
    gradients of the means before it reaches each rank's probabilities."""
    if not rows or not torch.is_grad_enabled():
        return frac, mean_p
    n = math.prod(mesh_axis(a).size for a in rows)
    out = []
    for t in (frac, mean_p):
        t = all_reduce_axes(t, rows) / n
        for axis in rows:
            t = sum_grad(t, axis)
        out.append(t)
    return tuple(out)


def _moe_weights(p: Params, cfg: ModelConfig, plan, div: Dict[str, int]):
    """(the expert weights a dispatch runs, E_local, this rank's first
    expert / E_local, whether the experts split over ``model``, the grouped
    ops' ``g_divisor``). Without a ranked plan: ``p`` itself, every expert,
    ``div``'s model divisor. With one: the weights gathered over their FSDP
    axes, this rank's ``E / model`` experts, unit divisors."""
    if plan is None:
        return p, cfg.n_experts, 0, False, div.get("model", 1)
    specs = moe_specs(cfg)
    w, parts = {}, {}
    for key in specs:
        w[key], parts[key] = _ranked_weight(p, key, specs[key], plan)
    mp = plan.mesh.shape.get("model", 1)
    split = _on_model(parts["w_in"], 0)
    if mp > 1 and not split:
        raise NotImplementedError(f"{cfg.n_experts} experts do not split over a model axis of "
                                  f"{mp}")
    e_loc = cfg.n_experts // mp if split else cfg.n_experts
    j = plan.mesh.coords.get("model", 0) if split else 0
    return w, e_loc, j, split, 1


def _row_offsets(onehot, e_flat, hinted: bool, k: int, tl: int, rows, plan):
    """What to add to each of this rank's assignments' local positions so
    that they are the positions the whole batch's order gives: every rank's
    per-(choice, expert) counts are all-gathered over the row axes ``rows``
    (rank-major, as :func:`~repro_torch.dist.sharding.rows_of` numbers the
    rows). Token-major (``hinted``): the earlier ranks' assignments to the
    expert come first. Rank-major (``global``): every rank's earlier
    choices, then the earlier ranks' same choice."""
    e = onehot.shape[-1]
    if hinted:
        cnt = onehot.reshape(tl, k, e).sum(dim=0)
    else:
        cnt = onehot.reshape(k, tl, e).sum(dim=1)
    every = cnt.to(torch.int32)[None]
    for axis in reversed(rows):  # innermost axis first
        every = raw_all_gather(every, mesh_axis(axis, plan.mesh), 0)
    index = 0
    for a in rows:
        index = index * plan.mesh.shape[a] + plan.mesh.coords[a]
    before = every[:index].sum(dim=0)  # (k, E): the earlier ranks' counts
    if hinted:
        return before.sum(dim=0)[e_flat]
    others = every.sum(dim=0) - every[index]
    off = torch.cumsum(others, dim=0) - others + before  # (k, E)
    choice = torch.arange(k, device=e_flat.device).repeat_interleave(tl)
    return off[choice, e_flat]


def _expert_dispatch(w: Params, src: torch.Tensor, tok, e_flat, slot, rows: int, e_loc: int,
                     j: int, cfg: ModelConfig, g_divisor: int, hint: bool = False):
    """Dispatch the assignments (source row ``src[tok]``, expert ``e_flat``,
    row ``slot`` of its ``rows``; ``rows`` is the trash row) to this rank's
    experts ``j * e_loc .. (j + 1) * e_loc - 1`` (the others' go to the
    trash row), run the expert MLP over ``(e_loc, rows, D)`` and gather each
    assignment's output back. Returns (outputs (A, D), whether each
    assignment's expert is this rank's)."""
    e_local = e_flat - j * e_loc
    mine = (e_local >= 0) & (e_local < e_loc)
    e_clamped = e_local.clamp(0, e_loc - 1)
    slot = torch.where(mine, slot, rows)
    buf = torch.zeros((e_loc, rows + 1, src.shape[-1]), dtype=src.dtype, device=src.device)
    buf = buf.index_put((e_clamped, slot), src[tok])
    expert_in = buf[:, :rows]
    if hint:
        expert_in = constrain(expert_in, "experts", None, None)
    out_e = _experts(w, expert_in, cfg, {}, g_divisor=g_divisor)  # (e_loc, rows, D)
    if hint:
        out_e = constrain(out_e, "experts", None, None)
    return out_e[e_clamped, torch.clamp_max(slot, rows - 1)], mine


def _experts(p: Params, expert_in: torch.Tensor, cfg: ModelConfig, div: Dict[str, int],
             g_divisor: Optional[int] = None) -> torch.Tensor:
    """The expert MLP over ``expert_in`` (E, rows, D): three grouped GEMMs
    (two with gelu), the activation in the epilogue and swiglu's gate
    multiplied into the up-projection's."""
    dg = div.get("model", 1) if g_divisor is None else g_divisor
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
    return gemm_grouped(h, p["w_out"], g_divisor=dg, tag="moe.out")


def moe_apply_sharded(
    p: Params, x: torch.Tensor, cfg: ModelConfig, *, div: Dict[str, int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_impl="sharded"``: shard-local capacity dispatch (``repro``'s
    ``moe_apply_sharded``). The tokens split into ``div["batch"]`` groups
    (one, when the count does not divide), each routed rank-major into its
    own ``(E, cap)`` buffer at a per-group capacity, as each data shard
    would route its own tokens; the groups then fold into M, so each expert
    contracts ``(G * cap, D)`` in one grouped GEMM. The router is a plain
    f32 einsum, as in ``repro``. Across ranks (:func:`moe_apply`) the
    groups are the data ranks': where the rows split over them, this rank's
    rows are its one group; where they stay whole, every rank routes all
    the data ranks' groups."""
    plan = ranked_plan()
    w, e_loc, j, split, dg = _moe_weights(p, cfg, plan, div)
    if plan is not None:
        x = seq_in(x, False)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    if plan is None:
        groups = div.get("batch", 1)
    else:
        groups = 1 if row_axes(plan) else math.prod(
            plan.mesh.shape[a] for a in batch_axes(plan))
    if t % groups:
        groups = 1
    tl = t // groups
    xg = constrain(x.reshape(groups, tl, d), "batch", None, None)

    logits = torch.einsum("gtd,de->gte", xg.to(torch.float32), w["router"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)  # (G, Tl, E)
    gates, idx = torch.topk(probs, k, dim=-1)  # (G, Tl, k)
    gates = gates / gates.sum(dim=-1, keepdim=True)

    cap = max(int(cfg.capacity_factor * tl * k / e), min(tl, 16), 1)
    # rank-major within each group (primary choices win capacity)
    e_flat = idx.transpose(1, 2).reshape(groups, tl * k)  # (G, kTl)
    onehot = F.one_hot(e_flat, e)  # (G, kTl, E)
    pos = (torch.cumsum(onehot, dim=1) * onehot - 1).amax(dim=-1)  # (G, kTl)
    keep = pos < cap

    # the groups fold into M: group g's row of expert e is g * cap + its
    # position there, so each expert contracts (G * cap, D) in one grouped op
    gidx = torch.arange(groups, device=x.device)[:, None]
    slot = torch.where(keep, gidx * cap + pos, groups * cap)
    tok = gidx * tl + torch.arange(tl, device=x.device).repeat(k)  # (G, kTl)
    xf = xg.reshape(t, d)
    src = sum_grad(xf, "model") if split else xf
    gathered, mine = _expert_dispatch(w, src, tok.reshape(-1), e_flat.reshape(-1),
                                      slot.reshape(-1), groups * cap, e_loc, j, cfg, dg)
    gates = sum_grad(gates, "model") if split else gates
    wts = (gates.transpose(1, 2).reshape(groups, tl * k) * keep
           * mine.reshape(groups, tl * k)).to(torch.float32)
    gathered = gathered.reshape(groups, tl * k, d)
    combined = (gathered.to(torch.float32) * wts[..., None]).reshape(groups, k, tl, d).sum(dim=1)
    combined = combined.reshape(b, s, d)
    if split:
        combined = sum_model(combined)

    frac = onehot.reshape(groups, k, tl, e).sum(dim=1).to(torch.float32).mean(dim=(0, 1))
    frac, mean_p = _batch_means(frac, probs.mean(dim=(0, 1)),
                                () if plan is None else row_axes(plan))
    aux = cfg.router_aux_coef * e * torch.sum(frac * mean_p)
    return combined.to(x.dtype), aux


def moe_apply_shard_map(
    p: Params, x: torch.Tensor, cfg: ModelConfig, *, div: Dict[str, int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_impl="shard_map"`` under a plan: ``repro``'s per-rank
    expert-parallel body. ``x`` is this rank's data row's tokens (replicated
    over ``model``), the expert weights its ``E / model`` experts
    (FSDP-gathered over ``data``). Routing is local and token-major at a
    per-data-row capacity; assignments to other ranks' experts go to the
    trash row; B5 runs at G = E / model with unit divisors; the combine is
    summed over ``model`` (in bf16 for ``shard_map_bf16``). The dispatch
    and the combine weights are the rank-partial consumers of the
    replicated tokens and gates, so their gradients are summed over
    ``model``; the router and the aux loss are replicated. On a one-rank
    mesh this body is the whole computation (one data row, every expert
    local, the sums the identity); a plan over a device-free mesh of more
    than one rank has no ranks to run it and raises."""
    plan = current_plan()
    ranks = math.prod(plan.mesh.shape.values())
    if ranks > 1 and ranked_plan(plan) is None:
        raise NotImplementedError(
            f"moe_impl={cfg.moe_impl!r} over a {ranks}-rank mesh runs on the multi-rank slice's "
            "ranks (make_host_mesh under torch.distributed); a device-free mesh has none"
        )
    w, e_loc, j, _, _ = _moe_weights(p, cfg, plan, div)
    if ranked_plan(plan) is not None:
        x = seq_in(x, False)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k

    t = b * s
    xf = x.reshape(t, d)
    logits = torch.matmul(xf.to(torch.float32), w["router"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True)

    cap = max(int(cfg.capacity_factor * t * k / e), min(t, 16), 1)
    e_flat = idx.reshape(t * k)  # token-major priority
    onehot = F.one_hot(e_flat, e)
    pos = (torch.cumsum(onehot, dim=0) * onehot - 1).amax(dim=-1)
    keep = pos < cap
    slot = pos.clamp_max(cap)

    # dispatch only into this rank's experts; the body's shapes are already
    # shard-local: unit divisors, G = e_loc
    tok = torch.arange(t, device=x.device).repeat_interleave(k)
    gathered, mine = _expert_dispatch(w, sum_grad(xf, "model"), tok, e_flat, slot, cap, e_loc,
                                      j, cfg, 1)
    wts = (sum_grad(gates, "model").reshape(t * k) * keep * mine).to(torch.float32)
    combined = (gathered.to(torch.float32) * wts[:, None]).reshape(t, k, d).sum(dim=1)
    combined = combined.reshape(b, s, d)
    if cfg.moe_impl == "shard_map_bf16" and "model" in plan.mesh.axis_names:
        # the bf16 combine: repro sums the ranks' partials in bf16
        combined = sum_model(combined.to(torch.bfloat16)).to(torch.float32)
    else:
        combined = sum_model(combined)

    frac = onehot.reshape(t, k, e).sum(dim=1).to(torch.float32).mean(dim=0)
    aux = cfg.router_aux_coef * e * torch.sum(frac * probs.mean(dim=0))
    return combined.to(x.dtype), aux
