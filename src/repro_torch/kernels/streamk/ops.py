"""Public wrapper for the Stream-K++ GEMM: the policy composition.

Counterpart of ``repro.kernels.streamk.ops.gemm``. It composes the policy's
phases (§4.1 of the paper):

  1. the Stream-K region (:func:`streamk_region`): the Stream-K sweep (B2)
     with its deterministic fix-up (B3) fused into its tail, which writes
     the SK tiles straight into C,
  2. the data-parallel region over the remaining tiles
     (:func:`dp_gemm_region`, B1, from ``tile_offset = sk_tiles``).

On the TPU the sweep and the fix-up are two kernels, in turn; on the card a
split tile's last contributor to arrive finishes it (an arrival counter per
tile, the contributor slots summed in the TPU fix-up's order), so a Stream-K
region is one launch and a HYBRID two. A partition whose Stream-K region is
empty (DP itself, or a HYBRID whose remainder wave is empty at this ``g``)
runs the DP region alone; ALL_SK has no phase 2. Nothing is padded: C is
allocated once at (M, N) and every kernel masks the ragged edges itself, so
a weight is never copied.

Quantized weights (int8, or int4 packed two nibbles per byte along K) go
through the same phases; their dequant scales apply in the flush of each
tile, never to the sweep's partials.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from repro_torch.core.policies import DP, Policy, TileConfig
from repro_torch.core.workpart import GemmShape, partition
from repro_torch.kernels.dp.dp_gemm import dp_gemm_region
from repro_torch.kernels.streamk.streamk_gemm import streamk_region

#: Partitions are static per (shape, tile, g, policy) and cost O(g + tiles)
#: Python objects to build; a serving loop dispatches the same few hundred
#: GEMMs every step, so they are built once (the JAX package gets the same
#: from jit's trace cache).
_partition = lru_cache(maxsize=4096)(partition)


def gemm(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    policy: Policy = DP,
    cfg: TileConfig = TileConfig(128, 128, 128),
    g: int = 8,
    out_dtype=None,
    epilogue="none",
    bias=None,
    operand=None,
    scale=None,
    scale_a=None,
    b_bits: int = 8,
) -> torch.Tensor:
    """``a @ b`` under a Stream-K++ scheduling policy with an optional fused
    epilogue (applied to the f32 accumulator where a tile is flushed).

    a: (M, K), b: (K, N) -> (M, N) in ``out_dtype`` (default ``a.dtype``);
    ``bias`` (N,) and ``operand`` (M, N) feed the epilogue's bias-add and
    binary stages. The quantized rungs pass ``b`` int8 — or, with
    ``b_bits=4``, packed int4 ``(ceil(K/2), N)`` — with its per-column
    dequant ``scale`` (N,), and for int8 activations ``a`` int8 with its
    per-row ``scale_a`` (M,). CPU tensors run the kernels' plain versions,
    CUDA tensors the Hopper kernels."""
    k_rows = (a.shape[-1] + 1) // 2 if b_bits == 4 else a.shape[-1]
    if a.dim() != 2 or b.dim() != 2 or b.shape[0] != k_rows:
        raise ValueError(f"bad gemm operands {tuple(a.shape)} @ {tuple(b.shape)} "
                         f"(b_bits={b_bits})")
    m, k = a.shape
    n = b.shape[1]
    out_dtype = out_dtype or a.dtype
    epi = dict(epilogue=epilogue, bias=bias, operand=operand, scale=scale, scale_a=scale_a)
    part = _partition(GemmShape(m, n, k), cfg, g, policy)
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if part.sk_tiles == 0:
        # the DP region still launches with the selected grid size
        return dp_gemm_region(a, b, cfg, c=c, g=g, b_bits=b_bits, **epi)

    streamk_region(a, b, part, c, b_bits=b_bits, **epi)
    if part.dp_tiles:
        dp_gemm_region(
            a, b, cfg, c=c, tile_offset=part.sk_tiles, g=g, b_bits=b_bits, **epi
        )
    return c
