"""Whisper-style encoder-decoder (the port's counterpart of
``repro.models.encdec``).

The conv frontend is a stub, as in ``repro``: the caller feeds the frame
embeddings (B, enc_frames, d_model) the two strided convs would produce.
Positions are sinusoidal and absolute in the encoder and the decoder; no
attention applies RoPE. Every projection goes through
:func:`repro_torch.core.gemm.gemm` under ``repro``'s tags (the cross K/V
projections as ``xattn.k``/``xattn.v``), and the head is tied to the token
embedding (:class:`~repro_torch.models.lm.TiedHead`: one contiguous copy of
``embed.T`` per embedding tensor).

The decode cache holds, per decoder layer, the self-attention K/V
(L, B, S_max, KV, dh), written in place at each step, and the
cross-attention K/V (L, B, enc_frames, KV, dh), computed once from the
encoder's output at prefill and carried through decode unchanged.
``loss_fn`` is ``repro``'s; under grad the encoder and decoder layers are
recomputed in the backward when ``cfg.remat``.

Across ranks (a ranked plan) it runs as the LM does (``models/lm.py``):
parameters and caches are this rank's shards, the attention and MLP
projections tensor-parallel over ``model`` and FSDP over ``data``
(``models/layers.py``), the decoder's embedding and tied head
vocab-parallel, and batch rows split over the data axes (``prefill`` and
``decode_step`` take the whole batch, run this rank's rows and gather the
logits). The cross K/V are computed from the encoder's output for this
rank's kv heads (:func:`~repro_torch.models.layers.project_kv`) and cached
as them, as ``repro``'s cross-cache spec places them, and cross-attention
is column-parallel on its queries with a row-parallel ``attn.o``.

Under a plan that puts ``seq`` on ``model`` ``forward`` runs each stack
sequence-parallel where ``model`` divides its length (the frames, the
decoder's tokens): the encoder's output is gathered along the frames
before the cross K/V, the decoder's stream before the head
(``models/lm.py``). Under ``kv_seq`` the self-attention cache holds this
rank's range of the positions and the cross cache its range of the frames
where the axes divide them (``repro``'s cross-cache spec); the ranks'
partial softmaxes combine (``models/layers.py``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.gemm import as_dtype, gemm
from repro_torch.dist.collectives import all_gather, split
from repro_torch.dist.sharding import (ArraySpec, check_kv_seq, constrain, kv_seq_split,
                                       local_specs, ranked_plan, residual_split, seq_sharded,
                                       seq_split)
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import (TiedHead, _map, _stack_specs, _zeros, by_rows, grad_tracking,
                                   init_ranked, kv_range, norm_leaves, ranked_loss_terms,
                                   remat_call, resolve_device, row_split, sum_metrics,
                                   vocab_head, vocab_lookup)

Params = Dict[str, Any]


def sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal embeddings (..., d) of ``positions`` in f32: sines, then
    cosines, at ``d / 2`` frequencies."""
    half = d // 2
    freqs = torch.exp(-math.log(10_000.0)
                      * torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class EncDec:
    """Encoder (L_enc x bidirectional attention and MLP over the frames) and
    decoder (L x causal self-attention, cross-attention over the encoder's
    output, MLP), layernorms, the tied head."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family != "encdec":
            raise ValueError(f"EncDec serves the encdec family, not {cfg.family!r}")
        self.cfg = cfg
        self._tied_head = TiedHead()

    # -- parameters ---------------------------------------------------------
    def param_specs(self) -> Params:
        """The ArraySpec tree of the parameters (``repro``'s tree and layout)."""
        cfg = self.cfg
        enc_layer = {
            "norm1": L.norm_spec(cfg),
            "attn": L.attn_specs(cfg),
            "norm2": L.norm_spec(cfg),
            "mlp": L.mlp_specs(cfg),
        }
        dec_layer = {
            "norm1": L.norm_spec(cfg),
            "self_attn": L.attn_specs(cfg),
            "norm2": L.norm_spec(cfg),
            "cross_attn": L.attn_specs(cfg),
            "norm3": L.norm_spec(cfg),
            "mlp": L.mlp_specs(cfg),
        }
        return {
            "embed": ArraySpec((cfg.vocab_size, cfg.d_model), cfg.dtype, ("vocab", "embed")),
            "enc_layers": _stack_specs(enc_layer, cfg.n_enc_layers),
            "enc_final_norm": L.norm_spec(cfg),
            "dec_layers": _stack_specs(dec_layer, cfg.n_layers),
            "final_norm": L.norm_spec(cfg),
        }

    def init_params(self, device=None, generator: Optional[torch.Generator] = None) -> Params:
        """Random weights drawn from ``generator`` (seed 0 when None) on
        ``device`` (the card unless ``device='cpu'``), leaf by leaf in the
        order of the spec tree; across ranks this rank's shards of them."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        return init_ranked(self.param_specs(), generator, dev)

    def head_weight(self, params) -> torch.Tensor:
        """The tied head's ``(d_model, vocab)`` weight, made once per
        embedding tensor and kept on the model."""
        return self._tied_head.weight(params["embed"], self.cfg.dtype)

    # -- encoder ----------------------------------------------------------------
    def _seq(self, batch: int, length: int, seq: bool) -> bool:
        """Whether a stack over ``length`` positions of this rank's
        ``batch`` rows runs sequence-parallel (``seq``: the caller's
        forward asks for it)."""
        return seq and residual_split(ranked_plan(), batch * row_split(), length)

    def encode(self, params: Params, frames: torch.Tensor, *,
               div: Optional[Dict[str, int]] = None, seq: bool = False) -> torch.Tensor:
        """The encoder's output (B, F, D) over the frame embeddings (B, F, D).
        ``seq``: sequence-parallel where the plan splits the frames (module
        doc); the output is whole on every rank either way."""
        cfg = self.cfg
        div = div or {}
        dt = as_dtype(cfg.dtype)
        f = frames.shape[1]
        x = frames.to(dt) + sinusoid(torch.arange(f, device=frames.device), cfg.d_model).to(dt)
        seq = self._seq(frames.shape[0], f, seq)
        with seq_sharded(seq):
            x = self._encoder(params, split(x, "model", 1) if seq else x, div)
        # the cross K/V's consumers sum its gradient where they are partial
        return all_gather(x, "model", 1, grad="slice") if seq else x

    def _encoder(self, params, x, div):
        cfg = self.cfg

        def layer(x, i):
            p = _map(lambda a: a[i], params["enc_layers"])
            h = L.norm_apply(p["norm1"], x, cfg)
            a, _ = L.attn_apply(p["attn"], h, cfg, div=div, mask_kind="bidir", use_rope=False)
            x = constrain(x + a, "batch", "seq", None)
            h = L.norm_apply(p["norm2"], x, cfg)
            return constrain(x + L.mlp_apply(p["mlp"], h, cfg, div=div), "batch", "seq", None)

        remat = cfg.remat and grad_tracking(params)
        for i in range(cfg.n_enc_layers):
            x = remat_call(remat, layer, x, i)
        return L.norm_apply(params["enc_final_norm"], x, cfg)

    # -- decoder ---------------------------------------------------------------
    def _dec_stack(self, params, x, enc_out, *, div, positions, cache=None, cur_pos=None):
        """The decoder layers over ``x`` (B, S, D). Without ``cache``: the
        cross K/V from ``enc_out``; returns (x, each layer's fresh
        ``{"attn": K/V, "cross": K/V}``). With ``cache``: one step at
        ``cur_pos``, the self-attention rows written in place and the cross
        K/V read from it; returns (x, None)."""
        cfg = self.cfg
        fresh = []

        def layer(x, i, enc_out):
            p = _map(lambda a: a[i], params["dec_layers"])
            layer = None if cache is None else {key: leaf[i] for key, leaf in cache["attn"].items()}
            h = L.norm_apply(p["norm1"], x, cfg)
            a, kv = L.attn_apply(p["self_attn"], h, cfg, div=div, positions=positions,
                                 use_rope=False, cache=layer, cur_pos=cur_pos)
            x = constrain(x + a, "batch", "seq", None)
            h = L.norm_apply(p["norm2"], x, cfg)
            entry = cross_split = None
            if cache is None:
                ck, cv = L.project_kv(p["cross_attn"], enc_out, cfg, div)
                entry = {"attn": kv, "cross": {"k": ck, "v": cv}}
            else:
                ck, cv = cache["cross"]["k"][i], cache["cross"]["v"][i]
                cross_split = self._cross_split(x.shape[0] * row_split())
            a, _ = L.attn_apply(p["cross_attn"], h, cfg, div=div, use_rope=False,
                                kv_override=(ck, cv), kv_split=cross_split)
            x = constrain(x + a, "batch", "seq", None)
            h = L.norm_apply(p["norm3"], x, cfg)
            x = constrain(x + L.mlp_apply(p["mlp"], h, cfg, div=div), "batch", "seq", None)
            return x, entry

        if cache is None and cfg.remat and grad_tracking(params):
            # training: each layer recomputed in the backward; the fresh
            # K/V (a serving handoff) are not kept
            for i in range(cfg.n_layers):
                x = remat_call(True, lambda x, i, e: layer(x, i, e)[0], x, i, enc_out)
            return x, None
        for i in range(cfg.n_layers):
            x, entry = layer(x, i, enc_out)
            fresh.append(entry)
        return x, (fresh if cache is None else None)

    def _dec_embed(self, params, tokens, positions):
        """The decoder's input (B, S, D); under sequence parallelism this
        rank's range of the positions."""
        dt = as_dtype(self.cfg.dtype)
        plan = ranked_plan()
        seq = seq_split()
        if plan is None:
            x = params["embed"][tokens]
        else:
            x = vocab_lookup(params["embed"], tokens, plan, self.param_specs()["embed"],
                             scatter=seq)
        pos = sinusoid(positions, self.cfg.d_model).to(dt)
        return x.to(dt) + (split(pos, "model", pos.dim() - 2) if seq else pos)

    def _head(self, params, x, div):
        cfg = self.cfg
        plan = ranked_plan()
        if plan is not None:
            parts = tuple(reversed(plan.spec_for(self.param_specs()["embed"])))
            return vocab_head(x, self.head_weight(params), parts, cfg.dtype)
        return gemm(x, self.head_weight(params),
                    divisors=(div.get("batch", 1), div.get("model", 1), 1), tag="lm_head",
                    out_dtype=cfg.dtype)

    # -- public ----------------------------------------------------------------
    def forward(self, params: Params, frames: torch.Tensor, dec_tokens: torch.Tensor, *,
                div: Optional[Dict[str, int]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced logits (B, S, V) of ``dec_tokens`` (B, S) over the
        frame embeddings ``frames`` (B, F, D), and a zero aux loss."""
        div = div or {}
        enc_out = self.encode(params, frames, div=div, seq=True)
        positions = torch.arange(dec_tokens.shape[1], device=dec_tokens.device)
        with seq_sharded(self._seq(*dec_tokens.shape, True)):
            x = self._dec_embed(params, dec_tokens, positions)
            x, _ = self._dec_stack(params, x, enc_out, div=div, positions=positions)
            x = L.norm_apply(params["final_norm"], x, self.cfg)
            logits = self._head(params, x, div)
        return logits, torch.zeros((), dtype=torch.float32, device=dec_tokens.device)

    def seq_parallel_leaves(self, batch) -> List[str]:
        """The parameter leaves a train step over ``batch`` applies to each
        rank's range of positions (the norms of each stack that runs
        sequence-parallel), whose gradients the step sums over ``model``."""
        specs = self.param_specs()
        b = batch["tokens"].shape[0]
        out = []
        if self._seq(b, batch["frames"].shape[1], True):
            out += norm_leaves(specs, "enc_")
        if self._seq(*batch["tokens"].shape, True):
            out += [n for n in norm_leaves(specs) if not n.startswith("enc_")]
        return out

    def loss_fn(self, params: Params, batch: Dict[str, torch.Tensor], *,
                div: Optional[Dict[str, int]] = None):
        """(loss, metrics) of a batch (``frames`` (B, F, D), ``tokens``,
        ``labels`` and optionally ``loss_mask`` (B, S)), as ``repro``'s
        ``EncDec.loss_fn``: the mean NLL over the mask with the logits in
        f32, no aux or z-loss; metrics ``nll`` and ``ntokens``. Under grad
        the encoder and decoder layers are recomputed in the backward when
        ``cfg.remat``."""
        logits, _ = self.forward(params, batch["frames"], batch["tokens"], div=div)
        labels = batch["labels"]
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
        # across ranks this rank's share of the global mean (LM.loss_fn)
        loss = ranked_loss_terms(logits, labels, mask)[0]
        return loss, sum_metrics({"nll": loss.detach(), "ntokens": torch.sum(mask).detach()})

    # -- serving -----------------------------------------------------------------
    def cache_specs(self, batch: int, max_seq: int) -> Params:
        """The ArraySpec tree of the decode cache (``repro``'s): ``attn``
        and ``cross``, ``{"k", "v"}`` each, (L, batch, max_seq, KV, dh) and
        (L, batch, enc_frames, KV, dh) in the model dtype."""
        cfg = self.cfg
        n, kv, dh = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
        axes = ("stack", "batch", "kv_seq", "kv_heads", None)
        return {
            "attn": {key: ArraySpec((n, batch, max_seq, kv, dh), cfg.dtype, axes, init="zeros")
                     for key in "kv"},
            "cross": {key: ArraySpec((n, batch, cfg.enc_frames, kv, dh), cfg.dtype, axes,
                                     init="zeros") for key in "kv"},
        }

    def init_cache(self, batch: int, max_seq: int, device=None):
        """The zeroed decode cache on ``device`` (the card unless
        ``device='cpu'``); across ranks this rank's shards of it."""
        specs = self.cache_specs(batch, max_seq)
        check_kv_seq(ranked_plan(), {"attn": specs["attn"]})
        return _zeros(local_specs(specs), resolve_device(device))

    def _cross_split(self, batch: int):
        """The ``kv_seq`` split of the cross cache of ``batch`` rows: the
        self cache's, where its axes divide the frames (else the frames are
        whole on every rank, as ``repro``'s spec demotes them)."""
        split_ = kv_seq_split(ranked_plan(), batch)
        return None if split_ is None or self.cfg.enc_frames % split_.n else split_

    def prefill(self, params: Params, frames: torch.Tensor, dec_tokens: torch.Tensor, *,
                max_seq: Optional[int] = None, div: Optional[Dict[str, int]] = None):
        """Encode ``frames`` (B, F, D), run the decoder prompt ``dec_tokens``
        (B, S), and build the decode cache (the prompt's self-attention rows,
        the cross K/V). Returns (last-position logits (B, 1, V), cache).
        Across ranks: the cache of this rank's rows, the logits of all
        (module doc)."""
        div = div or {}
        return by_rows(lambda t, f: self._prefill(params, f, t, max_seq, div), dec_tokens,
                       frames)

    def _prefill(self, params, frames, dec_tokens, max_seq, div):
        cfg = self.cfg
        b, s = dec_tokens.shape
        enc_out = self.encode(params, frames, div=div)
        positions = torch.arange(s, device=dec_tokens.device)
        x = self._dec_embed(params, dec_tokens, positions)
        x, fresh = self._dec_stack(params, x, enc_out, div=div, positions=positions)
        x = L.norm_apply(params["final_norm"], x, cfg)
        logits = self._head(params, x[:, -1:], div)
        # the cache of these rows: specs at the batch they are this rank's part of
        batch = b * row_split()
        specs = self.cache_specs(batch, max_seq or s)
        check_kv_seq(ranked_plan(), {"attn": specs["attn"]})
        local = local_specs(specs)
        cache = _zeros(local, dec_tokens.device)
        lo, n = kv_range(kv_seq_split(ranked_plan(), batch), local["attn"]["k"], s)
        flo, fn = kv_range(self._cross_split(batch), local["cross"]["k"], self.cfg.enc_frames)
        for i, entry in enumerate(fresh):
            for key in "kv":
                cache["attn"][key][i, :, :n] = entry["attn"][key][:, lo:lo + n]
                cache["cross"][key][i] = entry["cross"][key][:, flo:flo + fn]
        return logits, cache

    def decode_step(self, params: Params, cache, tokens: torch.Tensor, cur_pos: torch.Tensor,
                    *, div: Optional[Dict[str, int]] = None):
        """One decode step: ``tokens`` (B, 1) at ``cur_pos`` (B,). The
        self-attention cache is updated in place; the cross K/V are read as
        they are. Returns (logits (B, 1, V), cache). Across ranks: ``cache``
        of this rank's rows, the logits of all (module doc)."""
        div = div or {}

        def step(t, pos):
            positions = pos[:, None]
            x = self._dec_embed(params, t, positions)
            x, _ = self._dec_stack(params, x, None, div=div, positions=positions, cache=cache,
                                   cur_pos=pos)
            x = L.norm_apply(params["final_norm"], x, self.cfg)
            return self._head(params, x, div), cache

        return by_rows(step, tokens, cur_pos)
