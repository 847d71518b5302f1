"""Decoder-only LM (counterpart of the dense and MoE families of
``repro.models.lm``).

Parameters keep the JAX package's tree and layout — ``layers`` leaves are
stacked ``(L, ...)`` — so :func:`params_from_jax` carries ``repro``'s
parameters across leaf by leaf, quantized leaves included. The layer stack
is a Python loop over views ``leaf[i]`` in place of ``lax.scan`` (a
:class:`~repro_torch.core.quant.QuantizedTensor` leaf slices its values and
scales together); the decode cache is one stacked ``(L, B, S_max, KV, dh)``
pair written in place (int8, with f32 ``(L, B, S_max, KV)`` scales, under
``kv_cache_dtype="int8"``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

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
    lm_head, every projection through the Stream-K++ dispatch."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"the port serves the dense and moe families, not {cfg.family!r}"
            )
        if cfg.window or cfg.tie_embeddings:
            raise NotImplementedError("sliding windows and tied embeddings are not ported yet")
        if cfg.kv_cache_dtype not in ("model", "int8"):
            raise ValueError(f"kv_cache_dtype must be 'model' or 'int8', not "
                             f"{cfg.kv_cache_dtype!r}")
        self.cfg = cfg

    # -- parameters ---------------------------------------------------------
    def quantize_weights(
        self, params: Params, *, bits: int = 8, act_bits: Optional[int] = None
    ) -> Tuple[Params, int, int]:
        """Weight quantization for serving, as ``repro``'s
        ``LM.quantize_weights``: every projection leaf (attention, MLP and
        expert weights, lm_head) becomes a
        :class:`~repro_torch.core.quant.QuantizedTensor` on its own device;
        the embedding, routers and norms stay full precision. ``bits`` picks
        the rung (8, or 4 packed two nibbles per byte along K); ``act_bits=8``
        also quantizes the activations per row at dispatch. Stacked leaves
        are quantized one layer at a time. Returns (quantized tree, leaves
        converted, float leaves skipped under quantizable keys)."""
        return quantize_lm_params(params, bits=bits, act_bits=act_bits)

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
        return {
            "embed": ArraySpec((v, d), cfg.dtype, ("vocab", "embed")),
            "layers": _stack_specs(layer, cfg.n_layers),
            "final_norm": L.norm_spec(cfg),
            "lm_head": ArraySpec((d, v), cfg.dtype, ("embed", "vocab")),
        }

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

    def _head(self, params, x, div):
        return gemm(
            x,
            params["lm_head"],
            divisors=(div.get("batch", 1), div.get("model", 1), 1),
            tag="lm_head",
            out_dtype=self.cfg.dtype,
        )

    def _layer(self, p, x, *, div, positions, cache=None, cur_pos=None):
        cfg = self.cfg
        h = L.norm_apply(p["norm1"], x, cfg)
        attn_out, kv = L.attn_apply(
            p["attn"], h, cfg, div=div, positions=positions, cache=cache, cur_pos=cur_pos
        )
        x = x + attn_out
        h = L.norm_apply(p["norm2"], x, cfg)
        if cfg.family == "moe":
            out, _aux = L.moe_apply(p["moe"], h, cfg, div=div)  # serving drops the aux loss
            return x + out, kv
        return x + L.mlp_apply(p["mlp"], h, cfg, div=div), kv

    # -- serving -----------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, device=None):
        """Zeroed decode cache ``{"attn": {"k", "v"}}``, each
        ``(L, batch, max_seq, KV, dh)`` in the model dtype; with
        ``kv_cache_dtype="int8"`` they are int8 and ``k_scale``/``v_scale``
        ``(L, batch, max_seq, KV)`` f32 join them (``repro``'s
        ``cache_specs``)."""
        cfg = self.cfg
        dev = resolve_device(device)
        shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
        if cfg.kv_cache_dtype != "int8":
            dt = as_dtype(cfg.dtype)
            return {"attn": {key: torch.zeros(shape, dtype=dt, device=dev) for key in "kv"}}
        attn = {key: torch.zeros(shape, dtype=torch.int8, device=dev) for key in "kv"}
        for key in "kv":
            attn[f"{key}_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=dev)
        return {"attn": attn}

    def prefill(self, params: Params, tokens: torch.Tensor, *, max_seq: Optional[int] = None,
                div: Optional[Dict[str, int]] = None):
        """Run the prompt ``tokens`` (B, S), build the decode cache. Returns
        (last-position logits (B, 1, V), cache)."""
        cfg = self.cfg
        div = div or {}
        b, s = tokens.shape
        x = self._embed(params, tokens)
        positions = torch.arange(s, device=tokens.device)
        cache = self.init_cache(b, max_seq or s, device=tokens.device)
        for i in range(cfg.n_layers):
            p = _map(lambda a: a[i], params["layers"])
            x, kv = self._layer(p, x, div=div, positions=positions)
            for key in "kv":
                if cfg.kv_cache_dtype == "int8":
                    cache["attn"][key][i, :, :s], cache["attn"][f"{key}_scale"][i, :, :s] = (
                        L.kv_quantize(kv[key]))
                else:
                    cache["attn"][key][i, :, :s] = kv[key]
        x = L.norm_apply(params["final_norm"], x, cfg)
        return self._head(params, x[:, -1:], div), cache

    def decode_step(self, params: Params, cache, tokens: torch.Tensor, cur_pos: torch.Tensor,
                    *, div: Optional[Dict[str, int]] = None):
        """One decode step: ``tokens`` (B, 1) at ``cur_pos`` (B,). The cache
        is updated in place and returned. Returns (logits (B, 1, V), cache)."""
        cfg = self.cfg
        div = div or {}
        x = self._embed(params, tokens)
        positions = cur_pos[:, None]
        for i in range(cfg.n_layers):
            p = _map(lambda a: a[i], params["layers"])
            layer_cache = {key: leaf[i] for key, leaf in cache["attn"].items()}
            x, _ = self._layer(p, x, div=div, positions=positions, cache=layer_cache,
                               cur_pos=cur_pos)
        x = L.norm_apply(params["final_norm"], x, cfg)
        return self._head(params, x, div), cache
