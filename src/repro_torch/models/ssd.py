"""The Mamba2 / SSD block (state-space duality, arXiv:2405.21060), the
port's counterpart of ``repro.models.ssd``.

Prefill runs the chunked SSD algorithm: a quadratic "attention" inside each
chunk of ``ssm_chunk`` steps and a linear recurrence of the state across
chunks (a Python loop over the chunks in place of ``lax.scan``). Decode
carries the ``(heads, d_head, d_state)`` state and the conv tail per layer
and costs O(1) a token. Both projections go through
:func:`repro_torch.core.gemm.gemm` under ``repro``'s tags (``ssm.in``,
``ssm.out``), so the selector sees the same dispatches; the scan, the
depthwise conv and the gates are plain torch ops, as they are plain ``jnp``
ops in ``repro``.

``repro``'s three-operand einsums are contracted pairwise here, so no
``(B, nc, Q, Q, nh, dh)`` product is ever formed: at mamba2-1.3b's width
(Q = 256, nh = dh = 64) that would be 1.07 GB a layer in f32. The scan runs
in f32 throughout, and the casts to the model dtype sit where ``repro``
puts them: the conv output after its f32 silu, ``y`` before the ``silu(z)``
gate (which multiplies in the model dtype), and the decode conv in f32.

Across ranks (a ranked plan) the block runs head-parallel over ``model``
on ``repro``'s layout, whose cuts follow the ``ssm_inner`` rule and
nothing else: the fused ``w_in``'s columns split contiguously over
``model`` (not along the ``[z, x, B, C, dt]`` segments), the conv's
channels likewise (``conv_w``, ``conv_b`` and the decode cache's ``conv``
tail: a rank's ``conv_dim / model`` channels, aligned neither to heads nor
to ``B``/``C``), the state ``h`` on its heads, and ``w_out``'s rows,
head-aligned. Each rank runs ``ssm.in`` at its local columns and
all-gathers the projection; convolves its own channels (the conv is
depthwise) and all-gathers the conv's output; runs the scan on its heads
with all of ``B`` and ``C`` (one group) and its heads' ``z``, ``dt``,
``a``, ``D`` and ``dt_bias`` (replicated ``(nh,)``, sliced); and sums
``ssm.out``'s f32 partials over ``model`` (row-parallel). A dimension the
plan keeps whole (it does not divide the axis) is whole on every rank,
which then runs that part for every head or channel: :func:`ranked_layout`
reads each cut from ``plan.spec_for``. Where ``ssm.out``'s rows split,
each rank's gradient of what it holds whole (the per-head vectors
``a_log``, ``d_skip``, ``dt_bias``, and a whole conv or ``w_in``) covers
its own rows, and is summed over ``model``. In a sequence-parallel step the
block's input is gathered along the sequence before ``ssm.in`` and
``ssm.out`` is reduce-scattered along it (``models/layers.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.gemm import as_dtype, gemm
from repro_torch.dist.collectives import all_gather, sum_grad
from repro_torch.dist.sharding import ArraySpec, axes_of, ranked_plan
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _row_parallel, gather_weight, seq_in, seq_out

Params = Dict[str, torch.Tensor]


def ssd_specs(cfg: ModelConfig) -> Dict[str, ArraySpec]:
    """Specs of one Mamba2 block (``repro``'s tree and layout)."""
    d, din, ds, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = din + 2 * ds
    dt = cfg.dtype
    return {
        # the fused input projection: [z (din), x (din), B (ds), C (ds), dt (nh)]
        "w_in": ArraySpec((d, 2 * din + 2 * ds + nh), dt, ("embed", "ssm_inner")),
        "conv_w": ArraySpec((cfg.ssm_conv_width, conv_dim), dt, (None, "ssm_inner")),
        "conv_b": ArraySpec((conv_dim,), dt, ("ssm_inner",), init="zeros"),
        "a_log": ArraySpec((nh,), "float32", (None,), init="zeros"),
        "d_skip": ArraySpec((nh,), "float32", (None,), init="ones"),
        "dt_bias": ArraySpec((nh,), "float32", (None,), init="zeros"),
        "w_out": ArraySpec((din, d), dt, ("ssm_inner", "embed")),
    }


def ssd_cache_specs(cfg: ModelConfig, n: int, batch: int) -> Dict[str, ArraySpec]:
    """Specs of the stacked decode state of ``n`` Mamba2 layers
    (``repro``'s): ``h`` (n, batch, nh, dh, ds) in f32 on its heads, the
    conv tail (n, batch, width - 1, conv_dim) in the model dtype on its
    channels."""
    nh, dh, ds = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_dim = cfg.d_inner + 2 * ds
    return {
        "h": ArraySpec((n, batch, nh, dh, ds), "float32",
                       ("stack", "batch", "ssm_inner", None, None), init="zeros"),
        "conv": ArraySpec((n, batch, cfg.ssm_conv_width - 1, conv_dim), cfg.dtype,
                          ("stack", "batch", None, "ssm_inner"), init="zeros"),
    }


@dataclass(frozen=True)
class RankedLayout:
    """Where one rank's shards of a Mamba2 block sit in the whole block:
    each ``(lo, n)`` is the first index and the count of the rank's
    channels of the conv, heads (of ``h``, ``z``, ``x``, ``dt``) and rows of
    ``w_out``; ``split_*`` whether ``w_in``'s columns, the conv's channels
    and ``w_out``'s rows ride ``model``."""

    chans: Tuple[int, int]
    heads: Tuple[int, int]
    rows: Tuple[int, int]
    split_in: bool
    split_conv: bool
    split_out: bool


def ranked_layout(cfg: ModelConfig, plan) -> RankedLayout:
    """This rank's :class:`RankedLayout` under ``plan``, each cut read from
    ``plan.spec_for`` of the parameter and cache specs."""
    specs = ssd_specs(cfg)
    j = plan.mesh.coords.get("model", 0)

    def cut(size, part):
        split = "model" in axes_of(part)
        n = size // plan.mesh.shape["model"] if split else size
        return (j * n if split else 0, n), split

    split_in = "model" in axes_of(plan.spec_for(specs["w_in"])[1])
    chans, split_conv = cut(specs["conv_w"].shape[1], plan.spec_for(specs["conv_w"])[1])
    state = ssd_cache_specs(cfg, 1, 1)["h"]
    heads, _ = cut(cfg.ssm_heads, plan.spec_for(state)[2])
    rows, split_out = cut(cfg.d_inner, plan.spec_for(specs["w_out"])[0])
    return RankedLayout(chans, heads, rows, split_in, split_conv, split_out)


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    """(z, xBC, dt) of the fused projection's output."""
    din, ds = cfg.d_inner, cfg.ssm_state
    return (zxbcdt[..., :din], zxbcdt[..., din:2 * din + 2 * ds],
            zxbcdt[..., 2 * din + 2 * ds:])


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence by shifted adds (the width is
    tiny), in the input's dtype; the silu runs in f32 and is cast back."""
    width, s = w.shape[0], xbc.shape[1]
    out = xbc * w[width - 1]
    for i in range(1, width):
        shifted = F.pad(xbc, (0, 0, i, 0))[:, :s]
        out = out + shifted * w[width - 1 - i]
    return F.silu((out + b).to(torch.float32)).to(xbc.dtype)


def _ssd_chunked(
    x: torch.Tensor,  # (B, S, nh, dh)
    dt: torch.Tensor,  # (B, S, nh), softplus'd
    a: torch.Tensor,  # (nh,), negative
    b_in: torch.Tensor,  # (B, S, ds)
    c_in: torch.Tensor,  # (B, S, ds)
    chunk: int,
    h0: Optional[torch.Tensor] = None,  # (B, nh, dh, ds) initial state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD in f32: returns (y (B, S, nh, dh), final state
    (B, nh, dh, ds)). ``S`` must be a multiple of ``chunk``."""
    bsz, s, nh, dh = x.shape
    ds = b_in.shape[-1]
    nc = s // chunk
    if nc * chunk != s:
        raise ValueError(f"seq {s} must be a multiple of the chunk {chunk}")
    f32 = torch.float32
    xc = x.reshape(bsz, nc, chunk, nh, dh).to(f32)
    dtc = dt.reshape(bsz, nc, chunk, nh).to(f32)
    bc = b_in.reshape(bsz, nc, chunk, ds).to(f32)
    cc = c_in.reshape(bsz, nc, chunk, ds).to(f32)

    da_cs = torch.cumsum(dtc * a, dim=2)  # inclusive cumulative decay in the chunk (<= 0)

    # inside the chunk: L[i, j] = exp(da_cs[i] - da_cs[j]) for i >= j, else 0
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=x.device))
    lmat = torch.where(mask[None, None, :, :, None],
                       torch.exp(da_cs[:, :, :, None, :] - da_cs[:, :, None, :, :]), 0.0)
    scores = torch.einsum("bnis,bnjs->bnij", cc, bc)  # (B, nc, Q, Q)
    weights = (scores[..., None] * lmat).permute(0, 1, 4, 2, 3)  # (B, nc, nh, Qi, Qj)
    xdt = (xc * dtc[..., None]).permute(0, 1, 3, 2, 4)  # (B, nc, nh, Qj, dh)
    y_intra = torch.matmul(weights, xdt).permute(0, 1, 3, 2, 4)  # (B, nc, Q, nh, dh)

    # each chunk's contribution to the state: sum_j exp(da_cs[last] - da_cs[j]) dt_j B_j x_j
    decay_to_end = torch.exp(da_cs[:, :, -1:, :] - da_cs)  # (B, nc, Q, nh)
    states = torch.einsum("bnjhd,bnjs->bnhds", xc * (decay_to_end * dtc)[..., None], bc)
    chunk_decay = torch.exp(da_cs[:, :, -1, :])  # (B, nc, nh)

    # across chunks: the state before each chunk, then the final one
    h = h0.to(f32) if h0 is not None else torch.zeros(bsz, nh, dh, ds, dtype=f32,
                                                       device=x.device)
    h_starts = []
    for n in range(nc):
        h_starts.append(h)
        h = h * chunk_decay[:, n, :, None, None] + states[:, n]
    h_starts = torch.stack(h_starts, dim=1)  # (B, nc, nh, dh, ds)

    # the state's share of the output: y_i += exp(da_cs[i]) * C_i . h_start
    y_inter = torch.einsum("bnis,bnhds->bnihd", cc, h_starts) * torch.exp(da_cs)[..., None]
    return (y_intra + y_inter).reshape(bsz, s, nh, dh), h


def ssd_apply(
    p: Params,
    x: torch.Tensor,  # (B, S, D)
    cfg: ModelConfig,
    *,
    div: Dict[str, int],
    state: Optional[Dict[str, torch.Tensor]] = None,  # the decode carry
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The Mamba2 block. Without ``state`` (or with S > 1): the causal conv
    and the chunked SSD over the prompt, the prompt padded to the chunk with
    steps that leave the state as it was (``dt`` = 0 after the softplus:
    decay 1, input 0). With ``state`` and one token: the O(1) recurrence.
    Returns (output (B, S, D), the new state ``{"h", "conv"}``: new tensors,
    ``state`` is left as it was). Across ranks ``p`` and ``state`` are this
    rank's shards, and so is the new state (module doc)."""
    din, ds, dh = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    plan = ranked_plan()
    if plan is None:
        db, dtp = div.get("batch", 1), div.get("model", 1)
        zxbcdt = gemm(x, p["w_in"], divisors=(db, dtp, 1), tag="ssm.in")
        z, xbc_raw, dt_raw = _split_proj(cfg, zxbcdt)
        y, new_state = _scan(p, xbc_raw, dt_raw, cfg, state, heads=(0, cfg.ssm_heads),
                             conv_out=lambda c: c)
        y = y * F.silu(z.to(torch.float32)).to(x.dtype)
        return gemm(y, p["w_out"], divisors=(db, 1, dtp), tag="ssm.out"), new_state

    lay = ranked_layout(cfg, plan)
    specs = ssd_specs(cfg)
    # the gathers' consumers are this rank's heads: partial where ssm.out's
    # rows split (the gradient is summed back), whole on every rank else
    grad = "reduce_scatter" if lay.split_out else "slice"
    w_in = gather_weight(p["w_in"], plan.spec_for(specs["w_in"]))
    if lay.split_out:
        # the gradient from ssm.out's rows covers this rank's rows: what every
        # rank holds whole has its gradient summed over model
        whole = ("a_log", "d_skip", "dt_bias") + (() if lay.split_conv else ("conv_w", "conv_b"))
        p = dict(p, **{key: sum_grad(p[key], "model") for key in whole})
        if not lay.split_in:
            w_in = sum_grad(w_in, "model")
    zxbcdt = gemm(seq_in(x, lay.split_in or lay.split_out), w_in, tag="ssm.in")
    if lay.split_in:
        zxbcdt = all_gather(zxbcdt, "model", -1, grad=grad)
    h0, nhl = lay.heads
    z = zxbcdt[..., h0 * dh:(h0 + nhl) * dh]
    dt_raw = zxbcdt[..., 2 * din + 2 * ds + h0:][..., :nhl]
    c0, ncl = lay.chans
    xbc_raw = zxbcdt[..., din:2 * din + 2 * ds].narrow(-1, c0, ncl)

    def conv_out(c):  # this rank's channels of the conv's output -> all of them
        return all_gather(c, "model", -1, grad=grad) if lay.split_conv else c

    y, new_state = _scan(p, xbc_raw, dt_raw, cfg, state, heads=lay.heads, conv_out=conv_out)
    y = y * F.silu(z.to(torch.float32)).to(x.dtype)
    w_out = gather_weight(p["w_out"], plan.spec_for(specs["w_out"]))
    if not lay.split_out:
        return seq_out(gemm(y, w_out, tag="ssm.out")), new_state
    if nhl * dh != lay.rows[1]:  # every head here: the columns this rank's rows read
        y = y.narrow(-1, lay.rows[0], lay.rows[1])
    return _row_parallel(y, w_out, "ssm.out"), new_state


def _scan(p, xbc_raw, dt_raw, cfg: ModelConfig, state, *, heads, conv_out):
    """The conv and the SSD of heads ``heads`` (first, count): ``xbc_raw``
    (B, S, C) holds the pre-conv channels whose conv ``p["conv_w"]`` and
    ``p["conv_b"]`` hold (and ``state["conv"]`` the tail of), ``conv_out``
    maps their conv output to all ``conv_dim`` channels, ``dt_raw``
    (B, S, nhl) is the heads' dt before the softplus. Returns (y (B, S,
    nhl * dh) in the input's dtype, before the ``silu(z)`` gate; the new
    state of these heads and channels)."""
    bsz, s = xbc_raw.shape[:2]
    din, ds, dh = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    h0, nhl = heads
    dtype = xbc_raw.dtype
    f32 = torch.float32
    a = -torch.exp(p["a_log"][h0:h0 + nhl])
    d_skip = p["d_skip"][h0:h0 + nhl]
    dt = F.softplus(dt_raw.to(f32) + p["dt_bias"][h0:h0 + nhl])

    if state is None or s > 1:
        xbc = conv_out(_causal_conv(xbc_raw, p["conv_w"], p["conv_b"]))
        xs = xbc[..., h0 * dh:(h0 + nhl) * dh].reshape(bsz, s, nhl, dh)
        b_in, c_in = xbc[..., din:din + ds], xbc[..., din + ds:]
        pad = (-s) % cfg.ssm_chunk
        y, h_final = _ssd_chunked(
            F.pad(xs, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)), a,
            F.pad(b_in, (0, 0, 0, pad)), F.pad(c_in, (0, 0, 0, pad)), cfg.ssm_chunk,
            state["h"] if state is not None else None)
        y = y[:, :s] + xs * d_skip[None, None, :, None]
        new_state = {"h": h_final, "conv": conv_tail(xbc_raw, cfg, s)}
    else:
        conv_state = state["conv"]  # (B, width - 1, C)
        window = torch.cat([conv_state, xbc_raw], dim=1)
        conv = torch.einsum("bwc,wc->bc", window.to(f32), p["conv_w"].to(f32))
        xbc_t = conv_out(F.silu(conv + p["conv_b"].to(f32)).to(dtype))
        xs = xbc_t[:, h0 * dh:(h0 + nhl) * dh].reshape(bsz, nhl, dh).to(f32)
        b_t, c_t = xbc_t[:, din:din + ds].to(f32), xbc_t[:, din + ds:].to(f32)
        dt_t = dt[:, 0]  # (B, nhl)
        decay = torch.exp(dt_t * a)
        h = (state["h"] * decay[:, :, None, None]
             + (dt_t[:, :, None] * xs)[..., None] * b_t[:, None, None, :])
        y = torch.einsum("bhds,bs->bhd", h, c_t) + xs * d_skip[None, :, None]
        y = y[:, None]  # (B, 1, nhl, dh)
        new_state = {"h": h, "conv": torch.cat([conv_state[:, 1:], xbc_raw], dim=1)}
    return y.reshape(bsz, s, nhl * dh).to(dtype), new_state


def conv_tail(xbc_raw: torch.Tensor, cfg: ModelConfig, s: int) -> torch.Tensor:
    """The last ``ssm_conv_width - 1`` pre-conv inputs ``xbc_raw`` (B, S, C)
    of the prompt, the decode conv's cache (left-padded with zeros when the
    prompt is shorter)."""
    width = cfg.ssm_conv_width
    tail = xbc_raw[:, max(0, s - (width - 1)):s]
    if s < width - 1:
        tail = F.pad(tail, (0, 0, width - 1 - s, 0))
    return tail


def ssd_init_state(cfg: ModelConfig, batch: int, device=None) -> Dict[str, torch.Tensor]:
    """A zero state: ``h`` (B, nh, dh, ds) in f32 and the conv tail
    (B, width - 1, conv_dim) in the model dtype."""
    nh, dh, ds = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_dim = cfg.d_inner + 2 * ds
    return {
        "h": torch.zeros(batch, nh, dh, ds, dtype=torch.float32, device=device),
        "conv": torch.zeros(batch, cfg.ssm_conv_width - 1, conv_dim, dtype=as_dtype(cfg.dtype),
                            device=device),
    }
