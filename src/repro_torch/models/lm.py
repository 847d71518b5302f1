"""Decoder-only LM (counterpart of ``repro.models.lm``): the dense, MoE,
SSM (mamba2), hybrid (zamba2) and VLM (llava) families.

Parameters keep the JAX package's tree and layout — ``layers`` leaves are
stacked ``(L, ...)``, and a tied model has no ``lm_head`` leaf — so
:func:`params_from_jax` carries ``repro``'s parameters across leaf by leaf,
quantized leaves included. The layer stack is a Python loop over views
``leaf[i]`` in place of ``lax.scan`` (a
:class:`~repro_torch.core.quant.QuantizedTensor` leaf slices its values and
scales together), and gemma3's local:global pattern is a Python int window
per layer in place of ``repro``'s scanned flags. The decode cache is one
stacked ``(L, B, S_max, KV, dh)`` pair written in place (int8, with f32
``(L, B, S_max, KV)`` scales, under ``kv_cache_dtype="int8"``); with
``window_cache`` a local:global stack keeps ``window``-slot rings for its
local layers and full stripes for its global ones. An SSM or hybrid layer
is a Mamba2 block (:mod:`repro_torch.models.ssd`); its decode state is the
stacked ``ssm`` subtree, ``h`` (L, B, nh, dh, ds) in f32 and the conv tail
(L, B, width - 1, conv_dim), also written in place.

The hybrid's shared (weight-tied) attention and MLP block runs only at the
layers ``layer_flags()["use_attn"]`` marks (every ``attn_every``-th).
``repro`` runs it at every layer and multiplies its output by a 0/1 gate;
at an unmarked layer that adds exactly 0, so the logits are the same, and
a decode step reads the shared block's weights 6 times where the gate would
read them 38 (zamba2-1.2b). The cache keeps ``repro``'s layout, one
attention entry per layer, but only the marked layers' rows are written and
read (``repro`` also writes the unmarked layers' rows at prefill, and never
uses them).

A VLM's prompt may carry ``patch_embeds`` (B, P, D), the stubbed vision
frontend's output: they take the first P positions, and the first S - P
token embeddings follow them (``forward`` and ``prefill``).

Across ranks (a ranked plan; every family) parameters and caches are this
rank's shards (``init_params`` draws each full leaf as one rank would and
keeps its shard), the layers run tensor- and FSDP-parallel
(:mod:`repro_torch.models.layers`; a Mamba2 block head-parallel,
:mod:`repro_torch.models.ssd`, its ``ssm`` cache on this rank's heads and
conv channels), a VLM's patch embeddings are replicated over ``model``
and split over the data axes with their rows, the embedding is
vocab-parallel (each rank looks up the rows of its vocabulary range, then
an all-reduce over ``model``) and so is the head, whose logits are
all-gathered over ``model`` for sampling and the loss. Batch rows split
over the data axes; ``loss_fn`` then divides by the global token count.
Under a plan that puts ``seq`` on ``model`` (``repro``'s ``train_4k``
rule) ``forward`` runs sequence-parallel (:func:`~repro_torch.dist.sharding.residual_split`):
the embedding's sum is reduce-scattered along the sequence, the layer stack
runs on each rank's range of positions (``models/layers.py``), and the
head gathers them back; the norms' gradients then cover each rank's
positions and the train step sums them over ``model``
(:meth:`LM.seq_parallel_leaves`). A decode cache whose positions split
over the ``kv_seq`` axes (:func:`~repro_torch.dist.sharding.kv_seq_split`)
holds this rank's range of them; ``prefill`` keeps the prompt's rows
there, and a decode step writes and attends over them.
``forward`` and ``loss_fn`` take this rank's rows; the serving calls
(``prefill``, ``prefill_chunk``, ``decode_step``) take the whole batch
and a cache of this rank's rows, run this rank's rows where the data axes
divide the batch and gather the logits over them, so every rank samples
the same tokens; where they do not, every rank runs every row (``repro``'s
demotion, :func:`~repro_torch.dist.sharding.whole_rows`).
``quantize_weights`` quantizes the shards as ``repro`` quantizes the whole
leaves.

Training: ``loss_fn`` is ``repro``'s loss; under grad (a parameter that
requires it) ``forward`` recomputes each layer in the backward when
``cfg.remat`` (:func:`remat_call`), and the tied head's copy is made anew
in each forward so its gradient reaches the embedding.
"""

from __future__ import annotations

import math
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.gemm import as_dtype, current_context, gemm, installed_context
from repro_torch.core.quant import QuantizedTensor, quantize_lm_params
from repro_torch.dist.collectives import (
    all_gather,
    all_gather_rows,
    all_reduce,
    all_reduce_axes,
    reduce_scatter,
    split,
)
from repro_torch.dist.sharding import (
    ArraySpec,
    axes_of,
    batch_axes,
    check_kv_seq,
    constrain,
    current_plan,
    init_leaf,
    kv_seq_split,
    local_specs,
    ranked_plan,
    residual_split,
    row_axes,
    rows_of,
    seq_sharded,
    seq_split,
    shard_leaf,
    spec_items,
    use_plan,
    whole_rows,
)
from repro_torch.models import layers as L
from repro_torch.models import ssd
from repro_torch.models.config import ModelConfig
from repro_torch.utils.trees import tree_leaves

Params = Dict[str, Any]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the given one, else the CUDA
    device. Without a CUDA device and without an explicit request for the
    CPU this raises — an entry point never carries on on the CPU by itself."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: repro_torch entry points run on the card; pass "
            "device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def grad_tracking(params) -> bool:
    """Whether a forward over ``params`` builds a graph: grad is enabled and
    some parameter leaf requires grad (a training step, not a serve step)."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tree_leaves(params))


def remat_call(enabled: bool, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``enabled`` (the
    block's activations are recomputed in the backward, as ``repro``'s
    ``jax.checkpoint`` of its scanned layer body). The recompute runs under
    the caller's dispatch context (backend, selector, log), sharding plan
    and sequence split, also where the backward runs on autograd's device
    thread: all are thread-local, so it re-installs them and dispatches
    exactly as the forward did."""
    if not enabled:
        return fn(*args)
    ctx = current_context()
    plan = current_plan()
    seq = seq_split()

    def run(*a):
        with installed_context(ctx), use_plan(plan), seq_sharded(seq):
            return fn(*a)

    return checkpoint(run, *args, use_reentrant=False)


def token_loss(logits, labels, mask, denom=None):
    """(the masked mean NLL, logz (B, S), the mask's sum clamped to 1) of f32
    ``logits`` (B, S, V) against ``labels`` (B, S), as ``repro``'s loss
    functions compute them (logsumexp and the gold logit in f32).
    ``denom``: the count to divide by in place of the mask's sum (across
    ranks, the global one)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = (logz - gold) * mask
    denom = torch.clamp_min(torch.sum(mask) if denom is None else denom, 1.0)
    return torch.sum(nll) / denom, logz, denom


#: the window of a global layer in a windowed stack: effectively infinite
#: (``repro``'s ``2**30``), so one mask path serves both kinds of layer
GLOBAL_WINDOW = 2**30


def _zeros(specs, device):
    """Zeros of every spec of a cache tree (its dtype names a torch dtype:
    the model's, int8 or float32)."""
    return _map(lambda s: torch.zeros(s.shape, dtype=getattr(torch, s.dtype), device=device),
                specs)


def _stack_specs(spec, n: int):
    return _map(lambda s: ArraySpec((n, *s.shape), s.dtype, ("stack", *s.axes), s.init), spec)


def params_from_jax(tree, device=None) -> Params:
    """Carry the JAX package's parameters across: ``tree`` is ``repro``'s
    parameter tree with numpy leaves (the stacked ``(L, ...)`` layout), and
    the result is the same tree of torch tensors on ``device`` (the card
    unless ``device='cpu'``). Needs no jax: convert with ``np.asarray``
    before calling (``jax.tree.map`` does, and keeps ``repro``'s
    ``QuantizedTensor`` leaves, whose numpy values and scales, ``bits``,
    ``act_bits`` and ``k`` become a port :class:`QuantizedTensor`).
    bfloat16 leaves arrive as ml_dtypes arrays and are carried through
    their bit pattern."""
    dev = resolve_device(device)

    def array(a):
        a = np.array(a)  # a writable, contiguous copy torch may own
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
        return torch.from_numpy(a).to(dev)

    def leaf(a):
        if all(hasattr(a, f) for f in ("values", "scales", "bits", "act_bits", "k")):
            return QuantizedTensor(array(a.values), array(a.scales), bits=a.bits,
                                   act_bits=a.act_bits, k=a.k if a.bits == 4 else None)
        return array(a)

    return _map(leaf, tree)


class TiedHead:
    """The ``(d_model, vocab)`` weight a tied head reads: a contiguous copy
    of ``embed.T`` in the model dtype (the kernels read row-major operands).
    The copy is made once per embedding tensor and kept, so a dispatch never
    copies the table; an in-place write to the embedding (its version
    moves) or another embedding tensor rebuilds it. Under grad, with an
    embedding that requires it, the copy is made in each forward and never
    kept: a kept copy would hold one step's graph into the next, and the
    head's gradient must reach the embedding through it."""

    def __init__(self):
        #: (weak reference to the embedding it was built from, that tensor's
        #: version, the copy)
        self._entry = None

    def weight(self, embed: torch.Tensor, dtype) -> torch.Tensor:
        if torch.is_grad_enabled() and embed.requires_grad:
            return embed.T.to(as_dtype(dtype)).contiguous()
        entry = self._entry
        if entry is None or entry[0]() is not embed or entry[1] != embed._version:
            self._entry = None  # free the old copy before the new one is made
            head = embed.T.to(as_dtype(dtype)).contiguous()
            self._entry = (weakref.ref(embed), embed._version, head)
        return self._entry[2]


def init_ranked(specs, generator: torch.Generator, device):
    """Random weights of a spec tree on ``device``, leaf by leaf in the
    tree's order; under a ranked plan the same draws as one rank, each full
    leaf cut to this rank's shard at once (so the ranks hold one model and
    the card one leaf at a time)."""
    plan = ranked_plan()
    if plan is None:
        return _map(lambda s: init_leaf(s, generator, device), specs)
    return _map(lambda s: shard_leaf(init_leaf(s, generator, device), plan, s,
                                     plan.mesh.coords), specs)


def vocab_lookup(table, tokens, plan, spec: ArraySpec, scatter: bool = False) -> torch.Tensor:
    """Vocab-parallel lookup of ``tokens`` (B, S) in ``table``, this rank's
    shard of an embedding of spec ``spec``: the rows of this rank's
    vocabulary range (the table gathered over its FSDP axes), zero
    elsewhere, summed over ``model``. ``scatter``: the sum reduce-scattered
    along the sequence (sequence parallelism: this rank's range of the
    positions; a table whole on every rank keeps the range)."""
    parts = plan.spec_for(spec)
    table = L.gather_weight(table, parts)
    if "model" not in axes_of(parts[0]):
        x = table[tokens]
        return split(x, "model", 1) if scatter else x
    rows = table.shape[0]
    lo = plan.mesh.coords["model"] * rows
    local = tokens - lo
    inside = (local >= 0) & (local < rows)
    x = table[local.clamp(0, rows - 1)] * inside[..., None].to(table.dtype)
    return reduce_scatter(x, "model", 1) if scatter else all_reduce(x, "model")


def vocab_head(x, w, parts, dtype) -> torch.Tensor:
    """Vocab-parallel head: ``x`` against ``w``, this rank's vocabulary
    columns of the head weight (partition entries ``parts``; gathered over
    its FSDP axes), the logits all-gathered over ``model``; the loss over
    them is replicated, so the gather's backward keeps this rank's slice.
    Under sequence parallelism ``x`` is this rank's range of positions,
    gathered first (``layers.seq_in``)."""
    split_ = "model" in axes_of(parts[1])
    w = L.gather_weight(w, parts)
    xin = L.seq_in(x, split_)
    logits = gemm(xin, w, tag="lm_head", out_dtype=dtype)
    return all_gather(logits, "model", -1, grad="slice") if split_ else logits


def norm_leaves(specs, prefix: str = "") -> List[str]:
    """The paths of the norm leaves (``norm1``, ``final_norm``, ...) of a
    parameter spec tree whose path starts with ``prefix``."""
    out = []
    for path, _ in spec_items(specs):
        parts = path.split("/")
        if path.startswith(prefix) and any(p.startswith("norm") or p.endswith("_norm")
                                           for p in parts[:-1]):
            out.append(path)
    return out


def kv_range(split_, spec, prompt_len: int) -> Tuple[int, int]:
    """(the first position, the count) of a ``prompt_len``-token prompt's
    rows that this rank's cache keeps: its range under the ``kv_seq`` split
    ``split_`` of a cache of local spec ``spec`` (its positions on dim 2),
    or all of them."""
    if split_ is None or spec is None:
        return 0, prompt_len
    lo = split_.offset(spec.shape[2])
    return lo, max(0, min(prompt_len - lo, spec.shape[2]))


def row_split() -> int:
    """How many ranks the current call's rows split over (1 without a
    ranked plan, or under ``whole_rows``)."""
    plan = ranked_plan()
    return 1 if plan is None else math.prod(plan.mesh.shape[a] for a in row_axes(plan))


def by_rows(run, tokens, *cols):
    """``run(tokens, *cols)`` -> (logits, cache) on the rows this rank
    serves (module doc): under a ranked plan whose batch axes divide the
    batch, this rank's rows of ``tokens`` and of each per-row ``cols``,
    then the logits gathered over the batch axes; where they do not divide
    it, every row under ``whole_rows``."""
    plan = ranked_plan()
    axes = () if plan is None else batch_axes(plan)
    if not axes:
        return run(tokens, *cols)
    rows = rows_of(plan, tokens.shape[0])
    if rows is None:
        with whole_rows():
            return run(tokens, *cols)
    logits, cache = run(tokens[rows], *(c[rows] for c in cols))
    return all_gather_rows(logits, axes), cache


def ranked_loss_terms(logits, labels, mask):
    """(nll, logz, denom, the data rows' count, or 1 without them) of a
    batch's share: across ranks whose rows split over the data axes, this
    rank's sums over the global token count, so the shares' gradients add
    up to the mean's (:func:`token_loss`)."""
    plan = ranked_plan()
    rows = () if plan is None else batch_axes(plan)
    if not rows:
        return (*token_loss(logits, labels, mask), 1)
    total = all_reduce_axes(torch.sum(mask).detach(), rows)
    return (*token_loss(logits, labels, mask, denom=total),
            math.prod(plan.mesh.shape[a] for a in rows))


def sum_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A batch's metrics summed over the data axes its rows split over
    (each rank's shares of the global figures), or as they are."""
    plan = ranked_plan()
    rows = () if plan is None else batch_axes(plan)
    return {key: all_reduce_axes(v, rows) for key, v in metrics.items()}


class LM:
    """The LM: embed (a VLM's patch embeddings first) -> L x (norm, GQA
    attention, norm, MLP or MoE; or norm, Mamba2 block, and at the hybrid's
    marked layers the shared attention and MLP block) -> norm -> lm_head
    (or, tied, the embedding's transpose), every projection through the
    Stream-K++ dispatch."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family not in ("dense", "moe", "ssm", "hybrid", "vlm"):
            raise ValueError(f"LM serves the decoder-only families, not {cfg.family!r}")
        if cfg.kv_cache_dtype not in ("model", "int8"):
            raise ValueError(f"kv_cache_dtype must be 'model' or 'int8', not "
                             f"{cfg.kv_cache_dtype!r}")
        self.cfg = cfg
        self._tied_head = TiedHead()

    # -- parameters ---------------------------------------------------------
    def quantize_weights(
        self, params: Params, *, bits: int = 8, act_bits: Optional[int] = None
    ) -> Tuple[Params, int, int]:
        """Weight quantization for serving, as ``repro``'s
        ``LM.quantize_weights``: every projection leaf (attention, MLP and
        expert weights, the untied lm_head) becomes a
        :class:`~repro_torch.core.quant.QuantizedTensor` on its own device;
        the embedding (so a tied head), routers and norms stay full
        precision. ``bits`` picks the rung (8, or 4 packed two nibbles per
        byte along K); ``act_bits=8`` also quantizes the activations per row
        at dispatch. Stacked leaves are quantized one layer at a time.
        Under a ranked plan ``params`` are this rank's shards, and every
        rank calls this together: a leaf whose K the plan splits takes each
        column's amax over the whole K (module doc of ``core/quant.py``).
        Returns (quantized tree, leaves converted, float leaves skipped under
        quantizable keys)."""
        plan = ranked_plan()
        return quantize_lm_params(params, bits=bits, act_bits=act_bits, plan=plan,
                                  specs=None if plan is None else self.param_specs())

    @property
    def _has_ssm(self) -> bool:
        return self.cfg.family in ("ssm", "hybrid")

    def layer_flags(self) -> Dict[str, List[bool]]:
        """Per-layer flags: ``is_global``, gemma3's local:global pattern
        ``...LLLLLG`` (every ``global_every``-th layer is global; every layer
        is without it), and ``use_attn``, the layers where the hybrid's
        shared block runs (``i % attn_every == attn_every - 1``; none
        without it)."""
        cfg = self.cfg
        g, a = cfg.global_every, cfg.attn_every
        return {"is_global": [not g or (i + 1) % g == 0 for i in range(cfg.n_layers)],
                "use_attn": [bool(a) and i % a == a - 1 for i in range(cfg.n_layers)]}

    def _windows(self) -> List[Tuple[str, int]]:
        """(mask kind, window) of each layer: local layers of a windowed
        stack see ``cfg.window`` positions, global ones ``GLOBAL_WINDOW``."""
        cfg = self.cfg
        if not cfg.window:
            return [("causal", 0)] * cfg.n_layers
        return [("window", GLOBAL_WINDOW if g else cfg.window)
                for g in self.layer_flags()["is_global"]]

    def param_specs(self) -> Params:
        """The ArraySpec tree of the parameters (``repro``'s tree and layout)."""
        cfg = self.cfg
        d, v = cfg.d_model, cfg.vocab_size
        layer = {"norm1": L.norm_spec(cfg)}
        if self._has_ssm:
            layer["ssm"] = ssd.ssd_specs(cfg)
        else:
            layer["attn"] = L.attn_specs(cfg)
            layer["norm2"] = L.norm_spec(cfg)
            if cfg.family == "moe":
                layer["moe"] = L.moe_specs(cfg)
            else:
                layer["mlp"] = L.mlp_specs(cfg)
        specs = {
            "embed": ArraySpec((v, d), cfg.dtype, ("vocab", "embed")),
            "layers": _stack_specs(layer, cfg.n_layers),
            "final_norm": L.norm_spec(cfg),
        }
        if cfg.family == "hybrid" and cfg.attn_every:
            specs["shared_attn"] = {
                "norm1": L.norm_spec(cfg),
                "attn": L.attn_specs(cfg),
                "norm2": L.norm_spec(cfg),
                "mlp": L.mlp_specs(cfg),
            }
        if not cfg.tie_embeddings:
            specs["lm_head"] = ArraySpec((d, v), cfg.dtype, ("embed", "vocab"))
        return specs

    def init_params(self, device=None, generator: Optional[torch.Generator] = None) -> Params:
        """Random weights drawn from ``generator`` (seed 0 when None) on
        ``device`` (the card unless ``device='cpu'``), leaf by leaf in the
        order of the spec tree."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        return init_ranked(self.param_specs(), generator, dev)

    # -- embedding / head -----------------------------------------------------
    def _embed(self, params, tokens, patch_embeds=None, seq: bool = False):
        """Token embeddings (B, S, D) in the model dtype; a VLM's
        ``patch_embeds`` (B, P, D) take the first P positions and the first
        S - P token embeddings follow. ``seq``: this rank's range of the
        positions (sequence parallelism, module doc)."""
        dt = as_dtype(self.cfg.dtype)
        plan = ranked_plan()
        patches = self.cfg.family == "vlm" and patch_embeds is not None
        if plan is not None:
            x = vocab_lookup(params["embed"], tokens, plan, self.param_specs()["embed"],
                             scatter=seq and not patches).to(dt)
        else:
            x = params["embed"][tokens].to(dt)
        if patches:
            p = patch_embeds.to(dt)
            x = torch.cat([p, x[:, :x.shape[1] - p.shape[1]]], dim=1)
            if seq:
                x = split(x, "model", 1)
        # the residual stream: batch over the data-parallel axes
        return constrain(x, "batch", "seq", None)

    def head_weight(self, params) -> torch.Tensor:
        """The ``(d_model, vocab)`` weight the head reads: ``lm_head``, or,
        with tied embeddings, :class:`TiedHead`'s copy of ``embed.T``, made
        once per embedding tensor and kept on the model."""
        if not self.cfg.tie_embeddings:
            return params["lm_head"]
        return self._tied_head.weight(params["embed"], self.cfg.dtype)

    def _head(self, params, x, div):
        plan = ranked_plan()
        if plan is not None:
            specs = self.param_specs()
            if self.cfg.tie_embeddings:
                parts = tuple(reversed(plan.spec_for(specs["embed"])))
            else:
                parts = plan.spec_for(specs["lm_head"])
            return vocab_head(x, self.head_weight(params), parts, self.cfg.dtype)
        return gemm(
            x,
            self.head_weight(params),
            divisors=(div.get("batch", 1), div.get("model", 1), 1),
            tag="lm_head",
            out_dtype=self.cfg.dtype,
        )

    def _block(self, params, i, x, *, div, positions, window, cache=None, cur_pos=None):
        """Layer ``i`` of the stack; ``window`` is its (mask kind, window),
        ``cache`` the whole decode cache or None. Returns (x, its fresh cache
        entries, ``{"attn": K/V}`` and/or ``{"ssm": state}``, the MoE aux
        loss or 0). Against a cache, every entry is written in place."""
        p = self._layer_params(params, i)
        attn_cache = None if cache is None or "attn" not in cache else {
            key: leaf[i] for key, leaf in cache["attn"].items()}
        if not self._has_ssm:
            x, kv, aux = self._layer(p, x, div=div, positions=positions, window=window,
                                     cache=attn_cache, cur_pos=cur_pos)
            return x, {"attn": kv}, aux
        cfg = self.cfg
        state = None if cache is None else {key: leaf[i] for key, leaf in cache["ssm"].items()}
        h = L.norm_apply(p["norm1"], x, cfg)
        out, new_state = ssd.ssd_apply(p["ssm"], h, cfg, div=div, state=state)
        x = constrain(x + out, "batch", "seq", None)
        fresh = {"ssm": new_state}
        if state is not None:
            for key, leaf in new_state.items():
                state[key].copy_(leaf)
        if cfg.family == "hybrid" and self.layer_flags()["use_attn"][i]:
            shared = params["shared_attn"]
            h = L.norm_apply(shared["norm1"], x, cfg)
            out, fresh["attn"] = L.attn_apply(shared["attn"], h, cfg, div=div,
                                              positions=positions, cache=attn_cache,
                                              cur_pos=cur_pos)
            x = x + out
            h = L.norm_apply(shared["norm2"], x, cfg)
            x = x + L.mlp_apply(shared["mlp"], h, cfg, div=div)
        return x, fresh, 0.0

    def _layer(self, p, x, *, div, positions, window, cache=None, cur_pos=None):
        """One attention layer; ``window`` is the layer's (mask kind,
        window). Returns (x, fresh or cached K/V, the MoE aux loss or 0)."""
        cfg = self.cfg
        mask_kind, win = window
        h = L.norm_apply(p["norm1"], x, cfg)
        attn_out, kv = L.attn_apply(
            p["attn"], h, cfg, div=div, mask_kind=mask_kind, window=win, positions=positions,
            cache=cache, cur_pos=cur_pos,
        )
        x = constrain(x + attn_out, "batch", "seq", None)
        h = L.norm_apply(p["norm2"], x, cfg)
        if cfg.family == "moe":
            out, aux = L.moe_apply(p["moe"], h, cfg, div=div)
        else:
            out, aux = L.mlp_apply(p["mlp"], h, cfg, div=div), 0.0
        return constrain(x + out, "batch", "seq", None), kv, aux

    def _layer_params(self, params, i):
        return _map(lambda a: a[i], params["layers"])

    # -- teacher forcing ---------------------------------------------------------
    def forward(self, params: Params, tokens: torch.Tensor, *,
                div: Optional[Dict[str, int]] = None,
                patch_embeds: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced logits (B, S, V) of ``tokens`` (B, S) (a VLM's
        ``patch_embeds`` first) and the summed MoE aux load-balance loss (0
        for the other families)."""
        cfg = self.cfg
        div = div or {}
        seq = self.sequence_parallel(tokens.shape)
        x = self._embed(params, tokens, patch_embeds, seq=seq)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        remat = cfg.remat and grad_tracking(params)

        def block(x, i, window):
            x, _, aux_i = self._block(params, i, x, div=div, positions=positions, window=window)
            return x, aux_i

        with seq_sharded(seq):
            for i, window in enumerate(self._windows()):
                x, aux_i = remat_call(remat, block, x, i, window)
                aux = aux + aux_i
            x = L.norm_apply(params["final_norm"], x, cfg)
            return self._head(params, x, div), aux

    def sequence_parallel(self, shape) -> bool:
        """Whether ``forward`` over this rank's rows of ``shape`` (B, S)
        runs sequence-parallel under the installed plan (module doc)."""
        return residual_split(ranked_plan(), shape[0] * row_split(), shape[1])

    def seq_parallel_leaves(self, batch) -> List[str]:
        """The parameter leaves a train step over ``batch`` (this rank's
        rows) applies to each rank's range of positions, whose gradients the
        step sums over ``model``: the norms under sequence parallelism, else
        none."""
        if not self.sequence_parallel(batch["tokens"].shape):
            return []
        return norm_leaves(self.param_specs())

    def loss_fn(self, params: Params, batch: Dict[str, torch.Tensor], *,
                div: Optional[Dict[str, int]] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, metrics) of a batch, as ``repro``'s ``LM.loss_fn``: the
        mean NLL over ``loss_mask`` (all ones when absent; a VLM's patch
        positions masked out), plus the MoE aux loss and a ``1e-4`` z-loss on
        ``logsumexp``, with the logits in f32. ``batch`` holds ``tokens`` and
        ``labels`` (B, S), and optionally ``loss_mask`` (B, S) and a VLM's
        ``patch_embeds`` (B, P, D). Metrics: ``nll``, ``aux``, ``zloss``,
        ``ntokens`` (detached 0-d f32 tensors).

        Under grad each layer is recomputed in the backward when
        ``cfg.remat`` (``torch.utils.checkpoint``; the hybrid's shared block
        still only at its marked layers), and each attention chunk step when
        ``cfg.attn_remat``."""
        logits, aux = self.forward(params, batch["tokens"], div=div,
                                   patch_embeds=batch.get("patch_embeds"))
        labels = batch["labels"]
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
        if self.cfg.family == "vlm" and "patch_embeds" in batch:
            # no LM loss on image-patch positions
            mask = mask.clone()
            mask[:, : batch["patch_embeds"].shape[1]] = 0.0
        # across ranks this rank's share of the global mean, and of the aux
        # loss (the batch's, or under shard_map the mean of the data rows')
        nll, logz, denom, n_rows = ranked_loss_terms(logits, labels, mask)
        aux = aux / n_rows
        loss = nll + aux
        # z-loss for logit drift stability at scale
        zloss = 1e-4 * torch.sum(torch.square(logz) * mask) / denom
        metrics = {
            "nll": nll.detach(),
            "aux": torch.as_tensor(aux, dtype=torch.float32).detach(),
            "zloss": zloss.detach(),
            "ntokens": torch.sum(mask).detach(),
        }
        return loss + zloss, sum_metrics(metrics)

    # -- serving -----------------------------------------------------------------
    def cache_specs(self, batch: int, max_seq: int) -> Params:
        """The ArraySpec tree of the decode cache (``repro``'s): ``{"attn":
        {"k", "v"}}``, each ``(L, batch, max_seq, KV, dh)`` in the model
        dtype, or int8 with f32 ``k_scale``/``v_scale`` ``(L, batch,
        max_seq, KV)`` under ``kv_cache_dtype="int8"``; for the SSM and the
        hybrid ``{"ssm": {"h", "conv"}}``, ``h`` ``(L, batch, nh, dh, ds)``
        in f32 and ``conv`` ``(L, batch, width - 1, conv_dim)`` in the model
        dtype, beside the hybrid's ``attn``; a dense local:global stack with
        ``window_cache`` gets :meth:`cache_specs_windowed`."""
        if self._ring_cache:
            return self.cache_specs_windowed(batch, max_seq)
        return self._uniform_cache_specs(batch, max_seq)

    @property
    def _ring_cache(self) -> bool:
        """Whether decode keeps ring caches: ``window_cache`` on a dense or
        VLM local:global stack (``repro``'s condition)."""
        cfg = self.cfg
        return bool(cfg.window_cache and cfg.global_every and cfg.family in ("dense", "vlm"))

    def _uniform_cache_specs(self, batch: int, max_seq: int) -> Params:
        cfg = self.cfg
        n = cfg.n_layers
        out = {}
        if cfg.family != "ssm":
            shape = (n, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
            axes = ("stack", "batch", "kv_seq", "kv_heads", None)
            kv_dt = "int8" if cfg.kv_cache_dtype == "int8" else cfg.dtype
            attn = {key: ArraySpec(shape, kv_dt, axes, init="zeros") for key in "kv"}
            if cfg.kv_cache_dtype == "int8":
                for key in "kv":
                    attn[f"{key}_scale"] = ArraySpec(shape[:-1], "float32", axes[:-1],
                                                     init="zeros")
            out["attn"] = attn
        if self._has_ssm:
            out["ssm"] = ssd.ssd_cache_specs(cfg, n, batch)
        return out

    def _layer_split(self) -> Tuple[List[int], List[int]]:
        """The local and the global layers' indices, each in layer order:
        the order of the windowed cache's ``local`` and ``global`` stacks."""
        flags = self.layer_flags()["is_global"]
        return ([i for i, g in enumerate(flags) if not g],
                [i for i, g in enumerate(flags) if g])

    def cache_specs_windowed(self, batch: int, max_seq: int) -> Params:
        """Ring caches of ``window`` slots for the local layers (in layer
        order), full stripes for the 1-in-``global_every`` global layers:
        capacity and decode reads drop about ``global_every``-fold on long
        contexts."""
        cfg = self.cfg
        kv, dh, w = cfg.n_kv_heads, cfg.d_head, cfg.window
        local_idx, global_idx = self._layer_split()
        ring_axes = ("stack", "batch", None, "kv_heads", None)
        full_axes = ("stack", "batch", "kv_seq", "kv_heads", None)
        return {
            "local": {key: ArraySpec((len(local_idx), batch, w, kv, dh), cfg.dtype, ring_axes,
                                     init="zeros") for key in "kv"},
            "global": {key: ArraySpec((len(global_idx), batch, max_seq, kv, dh), cfg.dtype,
                                      full_axes, init="zeros") for key in "kv"},
        }

    def init_cache(self, batch: int, max_seq: int, device=None):
        """The zeroed decode cache of :meth:`cache_specs` on ``device`` (the
        card unless ``device='cpu'``); across ranks this rank's shards of
        it (a ``max_seq`` the ``kv_seq`` axes do not divide raises)."""
        specs = self.cache_specs(batch, max_seq)
        check_kv_seq(ranked_plan(), specs)
        return _zeros(local_specs(specs), resolve_device(device))

    def windowed_cache_from_uniform(self, cache, prompt_len: int):
        """A uniform prefill cache ``{"attn": {"k", "v"}}`` (L, B, S, KV, dh)
        in the windowed layout: local layers keep the last ``window``
        positions in ring order (position p -> slot p % W, the slots a
        decode chain of the same length would hold; slots no position
        reached are zero), global layers keep their full stripes. Prefill
        on the uniform cache, then windowed decode, is the serving handoff.
        The result is new tensors; ``cache`` is left as it was."""
        if kv_seq_split(ranked_plan(), cache["attn"]["k"].shape[1] * row_split()) is not None:
            raise NotImplementedError("the ring handoff reads the last window of positions, "
                                      "which a kv_seq split spreads over ranks")
        w = self.cfg.window
        local_idx, global_idx = self._layer_split()
        full_k = cache["attn"]["k"]
        s_max = full_k.shape[2]
        last = prompt_len - 1
        slots = torch.arange(w, device=full_k.device)
        pos = last - torch.remainder(last - slots, w)  # negative: not reached
        src = pos.clamp(0, s_max - 1)
        keep = (pos >= 0)[None, None, :, None, None]

        def to_ring(full):
            ring = full[local_idx][:, :, src]
            return torch.where(keep, ring, torch.zeros((), dtype=ring.dtype,
                                                       device=ring.device))

        return {"local": {key: to_ring(cache["attn"][key]) for key in "kv"},
                "global": {key: cache["attn"][key][global_idx] for key in "kv"}}

    def decode_step_windowed(self, params: Params, cache, tokens: torch.Tensor,
                             cur_pos: torch.Tensor, *, div: Optional[Dict[str, int]] = None):
        """One decode step against the windowed cache of
        :meth:`cache_specs_windowed`: local layers attend over their ring
        (:func:`~repro_torch.models.layers.attn_apply_ring`), global layers
        over their full stripe; both write the new row in place. The same
        logits as the uniform cache's step (ring == window mask). Returns
        (logits (B, 1, V), cache)."""
        cfg = self.cfg
        div = div or {}
        x = self._embed(params, tokens)
        n_local = n_global = 0
        for i, is_global in enumerate(self.layer_flags()["is_global"]):
            p = self._layer_params(params, i)
            h = L.norm_apply(p["norm1"], x, cfg)
            if is_global:
                layer_cache = {key: leaf[n_global] for key, leaf in cache["global"].items()}
                a, _ = L.attn_apply(p["attn"], h, cfg, div=div, positions=cur_pos[:, None],
                                    cache=layer_cache, cur_pos=cur_pos)
                n_global += 1
            else:
                ring = {key: leaf[n_local] for key, leaf in cache["local"].items()}
                a, _ = L.attn_apply_ring(p["attn"], h, cfg, div=div, cache=ring,
                                         cur_pos=cur_pos)
                n_local += 1
            x = x + a
            h = L.norm_apply(p["norm2"], x, cfg)
            x = x + L.mlp_apply(p["mlp"], h, cfg, div=div)
        x = L.norm_apply(params["final_norm"], x, cfg)
        return self._head(params, x, div), cache

    def prefill(self, params: Params, tokens: torch.Tensor, *, max_seq: Optional[int] = None,
                div: Optional[Dict[str, int]] = None,
                patch_embeds: Optional[torch.Tensor] = None,
                cache_batch: Optional[int] = None):
        """Run the prompt ``tokens`` (B, S) (a VLM's ``patch_embeds`` first),
        build the uniform decode cache (also under ``window_cache``:
        ``windowed_cache_from_uniform`` makes the windowed one from it); an
        SSM layer hands its final state and conv tail over. Returns
        (last-position logits (B, 1, V), cache). Across ranks: the cache of
        this rank's rows, the logits of all (module doc); its positions are
        this rank's range where the ``kv_seq`` axes split a cache of
        ``cache_batch`` rows (default B: a slot engine passes its slots, so
        the prompt's cache splits as the engine's does)."""
        div = div or {}
        if patch_embeds is None:
            return by_rows(lambda t: self._prefill(params, t, max_seq, div, None, cache_batch),
                           tokens)
        return by_rows(lambda t, pe: self._prefill(params, t, max_seq, div, pe, cache_batch),
                       tokens, patch_embeds)

    def _prefill(self, params, tokens, max_seq, div, patch_embeds, cache_batch=None):
        cfg = self.cfg
        b, s = tokens.shape
        x = self._embed(params, tokens, patch_embeds)
        positions = torch.arange(s, device=tokens.device)
        # the cache of these rows: specs at the batch they are this rank's
        # part of (or the batch whose layout they take), cut to b rows
        batch = cache_batch or b * row_split()
        specs = self._uniform_cache_specs(batch, max_seq or s)
        plan = ranked_plan()
        check_kv_seq(plan, specs)
        local = _map(lambda sp: ArraySpec(sp.shape[:1] + (b,) + sp.shape[2:], sp.dtype, sp.axes,
                                          sp.init), local_specs(specs))
        cache = _zeros(local, tokens.device)
        # this rank's range of the positions (all of them without a kv_seq split)
        lo, n = kv_range(kv_seq_split(plan, batch), local.get("attn", {}).get("k"), s)
        for i, window in enumerate(self._windows()):
            x, fresh, _ = self._block(params, i, x, div=div, positions=positions, window=window)
            for key, leaf in fresh.get("ssm", {}).items():
                cache["ssm"][key][i] = leaf
            kv = fresh.get("attn")
            if kv is None:
                continue
            for key in "kv":
                rows = kv[key][:, lo:lo + n]
                if cfg.kv_cache_dtype == "int8":
                    cache["attn"][key][i, :, :n], cache["attn"][f"{key}_scale"][i, :, :n] = (
                        L.kv_quantize(rows))
                else:
                    cache["attn"][key][i, :, :n] = rows
        x = L.norm_apply(params["final_norm"], x, cfg)
        return self._head(params, x[:, -1:], div), cache

    def prefill_chunk(self, params: Params, cache, tokens: torch.Tensor, cur_pos: torch.Tensor,
                      *, div: Optional[Dict[str, int]] = None):
        """One prompt chunk ``tokens`` (B, C) against an existing decode
        cache: the chunk's K/V rows are written IN PLACE at ``cur_pos ..
        cur_pos + C - 1`` (``cur_pos`` (B,): the chunk's first position) and
        each query row attends over the cache prefix and the chunk's causal
        span, so chaining chunks over a split prompt is the incremental
        :meth:`prefill`. Returns (last-position logits (B, 1, V), cache).
        Only the attention-cache families with the uniform cache, as
        ``repro``'s ``prefill_chunk``."""
        cfg = self.cfg
        if cfg.family not in ("dense", "vlm", "moe"):
            raise ValueError(
                f"prefill_chunk supports attention-cache families, not {cfg.family!r} "
                "(SSM state has no incremental chunk scatter)")
        if cfg.window_cache:
            raise ValueError("prefill_chunk requires the uniform decode cache; ring caches "
                             "drop positions later chunks must attend over")
        div = div or {}

        def chunk(t, p):
            x = self._cached_layers(params, cache, t, p, div)
            return self._head(params, x[:, -1:], div), cache

        return by_rows(chunk, tokens, cur_pos)

    def decode_step(self, params: Params, cache, tokens: torch.Tensor, cur_pos: torch.Tensor,
                    *, div: Optional[Dict[str, int]] = None):
        """One decode step: ``tokens`` (B, 1) at ``cur_pos`` (B,). The cache
        is updated in place and returned (a windowed cache through
        :meth:`decode_step_windowed`). Returns (logits (B, 1, V), cache).
        Across ranks: ``cache`` of this rank's rows, the logits of all
        (module doc)."""
        div = div or {}

        def step(t, p):
            if self._ring_cache:
                return self.decode_step_windowed(params, cache, t, p, div=div)
            return self._head(params, self._cached_layers(params, cache, t, p, div), div), cache

        return by_rows(step, tokens, cur_pos)

    def _cached_layers(self, params, cache, tokens, cur_pos, div):
        """The layer stack over ``tokens`` (B, S) at ``cur_pos .. cur_pos +
        S - 1`` against the uniform decode cache, which each layer writes in
        place; returns the final-norm hidden states (B, S, D)."""
        x = self._embed(params, tokens)
        positions = cur_pos[:, None] + torch.arange(tokens.shape[1], device=tokens.device)
        for i, window in enumerate(self._windows()):
            x, _, _ = self._block(params, i, x, div=div, positions=positions, window=window,
                                  cache=cache, cur_pos=cur_pos)
        return L.norm_apply(params["final_norm"], x, self.cfg)
