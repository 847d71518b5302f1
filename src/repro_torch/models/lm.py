"""Decoder-only LM (counterpart of the dense and MoE families of
``repro.models.lm``).

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
local layers and full stripes for its global ones.
"""

from __future__ import annotations

import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.gemm import as_dtype, gemm
from repro_torch.core.quant import QuantizedTensor, quantize_lm_params
from repro_torch.dist.sharding import ArraySpec, init_leaf
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

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


class LM:
    """The LM: embed -> L x (norm, GQA attention, norm, MLP or MoE) -> norm ->
    lm_head (or, tied, the embedding's transpose), every projection through
    the Stream-K++ dispatch."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"the port serves the dense and moe families, not {cfg.family!r}: the "
                "ssm/hybrid block (models/ssd.py), the encoder-decoder and the VLM frontend "
                "are not ported yet (ROADMAP A7)"
            )
        if cfg.kv_cache_dtype not in ("model", "int8"):
            raise ValueError(f"kv_cache_dtype must be 'model' or 'int8', not "
                             f"{cfg.kv_cache_dtype!r}")
        self.cfg = cfg
        #: the tied head: (weak reference to the embedding it was built from,
        #: that tensor's version, the contiguous (d_model, vocab) copy)
        self._tied_head = None

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
        Returns (quantized tree, leaves converted, float leaves skipped under
        quantizable keys)."""
        return quantize_lm_params(params, bits=bits, act_bits=act_bits)

    def layer_flags(self) -> Dict[str, List[bool]]:
        """Per-layer flags: ``is_global``, gemma3's local:global pattern
        ``...LLLLLG`` (every ``global_every``-th layer is global; every layer
        is without it)."""
        cfg = self.cfg
        g = cfg.global_every
        return {"is_global": [not g or (i + 1) % g == 0 for i in range(cfg.n_layers)]}

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
        layer = {
            "norm1": L.norm_spec(cfg),
            "attn": L.attn_specs(cfg),
            "norm2": L.norm_spec(cfg),
        }
        if cfg.family == "moe":
            layer["moe"] = L.moe_specs(cfg)
        else:
            layer["mlp"] = L.mlp_specs(cfg)
        specs = {
            "embed": ArraySpec((v, d), cfg.dtype, ("vocab", "embed")),
            "layers": _stack_specs(layer, cfg.n_layers),
            "final_norm": L.norm_spec(cfg),
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
        return _map(lambda s: init_leaf(s, generator, dev), self.param_specs())

    # -- embedding / head -----------------------------------------------------
    def _embed(self, params, tokens):
        return params["embed"][tokens].to(as_dtype(self.cfg.dtype))

    def head_weight(self, params) -> torch.Tensor:
        """The ``(d_model, vocab)`` weight the head reads: ``lm_head``, or,
        with tied embeddings, a contiguous copy of ``embed.T`` in the model
        dtype (the kernels read row-major operands). The copy is made once
        per embedding tensor and kept on the model, so a decode step never
        copies the table; an in-place write to the embedding (its version
        moves) or another parameter tree rebuilds it."""
        if not self.cfg.tie_embeddings:
            return params["lm_head"]
        embed = params["embed"]
        cached = self._tied_head
        if cached is None or cached[0]() is not embed or cached[1] != embed._version:
            self._tied_head = None  # free the old copy before the new one is made
            head = embed.T.to(as_dtype(self.cfg.dtype)).contiguous()
            self._tied_head = (weakref.ref(embed), embed._version, head)
        return self._tied_head[2]

    def _head(self, params, x, div):
        return gemm(
            x,
            self.head_weight(params),
            divisors=(div.get("batch", 1), div.get("model", 1), 1),
            tag="lm_head",
            out_dtype=self.cfg.dtype,
        )

    def _layer(self, p, x, *, div, positions, window, cache=None, cur_pos=None):
        """One decoder layer; ``window`` is the layer's (mask kind, window).
        Returns (x, fresh or cached K/V, the MoE aux loss or 0)."""
        cfg = self.cfg
        mask_kind, win = window
        h = L.norm_apply(p["norm1"], x, cfg)
        attn_out, kv = L.attn_apply(
            p["attn"], h, cfg, div=div, mask_kind=mask_kind, window=win, positions=positions,
            cache=cache, cur_pos=cur_pos,
        )
        x = x + attn_out
        h = L.norm_apply(p["norm2"], x, cfg)
        if cfg.family == "moe":
            out, aux = L.moe_apply(p["moe"], h, cfg, div=div)
            return x + out, kv, aux
        return x + L.mlp_apply(p["mlp"], h, cfg, div=div), kv, 0.0

    def _layer_params(self, params, i):
        return _map(lambda a: a[i], params["layers"])

    # -- teacher forcing ---------------------------------------------------------
    def forward(self, params: Params, tokens: torch.Tensor, *,
                div: Optional[Dict[str, int]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced logits (B, S, V) of ``tokens`` (B, S) and the summed
        MoE aux load-balance loss (0 for a dense model)."""
        cfg = self.cfg
        div = div or {}
        x = self._embed(params, tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for i, window in enumerate(self._windows()):
            x, _, aux_i = self._layer(self._layer_params(params, i), x, div=div,
                                      positions=positions, window=window)
            aux = aux + aux_i
        x = L.norm_apply(params["final_norm"], x, cfg)
        return self._head(params, x, div), aux

    # -- serving -----------------------------------------------------------------
    def cache_specs(self, batch: int, max_seq: int) -> Params:
        """The ArraySpec tree of the decode cache (``repro``'s): ``{"attn":
        {"k", "v"}}``, each ``(L, batch, max_seq, KV, dh)`` in the model
        dtype, or int8 with f32 ``k_scale``/``v_scale`` ``(L, batch,
        max_seq, KV)`` under ``kv_cache_dtype="int8"``; a dense local:global
        stack with ``window_cache`` gets :meth:`cache_specs_windowed`."""
        if self._ring_cache:
            return self.cache_specs_windowed(batch, max_seq)
        return self._uniform_cache_specs(batch, max_seq)

    @property
    def _ring_cache(self) -> bool:
        """Whether decode keeps ring caches: ``window_cache`` on a dense
        local:global stack (``repro``'s condition)."""
        cfg = self.cfg
        return bool(cfg.window_cache and cfg.global_every and cfg.family == "dense")

    def _uniform_cache_specs(self, batch: int, max_seq: int) -> Params:
        cfg = self.cfg
        shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
        axes = ("stack", "batch", "kv_seq", "kv_heads", None)
        kv_dt = "int8" if cfg.kv_cache_dtype == "int8" else cfg.dtype
        attn = {key: ArraySpec(shape, kv_dt, axes, init="zeros") for key in "kv"}
        if cfg.kv_cache_dtype == "int8":
            for key in "kv":
                attn[f"{key}_scale"] = ArraySpec(shape[:-1], "float32", axes[:-1], init="zeros")
        return {"attn": attn}

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
        card unless ``device='cpu'``)."""
        return _zeros(self.cache_specs(batch, max_seq), resolve_device(device))

    def windowed_cache_from_uniform(self, cache, prompt_len: int):
        """A uniform prefill cache ``{"attn": {"k", "v"}}`` (L, B, S, KV, dh)
        in the windowed layout: local layers keep the last ``window``
        positions in ring order (position p -> slot p % W, the slots a
        decode chain of the same length would hold; slots no position
        reached are zero), global layers keep their full stripes. Prefill
        on the uniform cache, then windowed decode, is the serving handoff.
        The result is new tensors; ``cache`` is left as it was."""
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
                div: Optional[Dict[str, int]] = None):
        """Run the prompt ``tokens`` (B, S), build the uniform decode cache
        (also under ``window_cache``: ``windowed_cache_from_uniform`` makes
        the windowed one from it). Returns
        (last-position logits (B, 1, V), cache)."""
        cfg = self.cfg
        div = div or {}
        b, s = tokens.shape
        x = self._embed(params, tokens)
        positions = torch.arange(s, device=tokens.device)
        cache = _zeros(self._uniform_cache_specs(b, max_seq or s), tokens.device)
        for i, window in enumerate(self._windows()):
            x, kv, _ = self._layer(self._layer_params(params, i), x, div=div,
                                   positions=positions, window=window)
            for key in "kv":
                if cfg.kv_cache_dtype == "int8":
                    cache["attn"][key][i, :, :s], cache["attn"][f"{key}_scale"][i, :, :s] = (
                        L.kv_quantize(kv[key]))
                else:
                    cache["attn"][key][i, :, :s] = kv[key]
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
        x = self._cached_layers(params, cache, tokens, cur_pos, div)
        return self._head(params, x[:, -1:], div), cache

    def decode_step(self, params: Params, cache, tokens: torch.Tensor, cur_pos: torch.Tensor,
                    *, div: Optional[Dict[str, int]] = None):
        """One decode step: ``tokens`` (B, 1) at ``cur_pos`` (B,). The cache
        is updated in place and returned (a windowed cache through
        :meth:`decode_step_windowed`). Returns (logits (B, 1, V), cache)."""
        div = div or {}
        if self._ring_cache:
            return self.decode_step_windowed(params, cache, tokens, cur_pos, div=div)
        x = self._cached_layers(params, cache, tokens, cur_pos, div)
        return self._head(params, x, div), cache

    def _cached_layers(self, params, cache, tokens, cur_pos, div):
        """The layer stack over ``tokens`` (B, S) at ``cur_pos .. cur_pos +
        S - 1`` against the uniform decode cache, which each layer writes in
        place; returns the final-norm hidden states (B, S, D)."""
        x = self._embed(params, tokens)
        positions = cur_pos[:, None] + torch.arange(tokens.shape[1], device=tokens.device)
        for i, window in enumerate(self._windows()):
            layer_cache = {key: leaf[i] for key, leaf in cache["attn"].items()}
            x, _, _ = self._layer(self._layer_params(params, i), x, div=div,
                                  positions=positions, window=window, cache=layer_cache,
                                  cur_pos=cur_pos)
        return L.norm_apply(params["final_norm"], x, self.cfg)
