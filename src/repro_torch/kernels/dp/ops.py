"""Public wrapper for the data-parallel tiled GEMM baseline (counterpart of
``repro.kernels.dp.ops``): B1 over every output tile, from ``tile_offset =
0``, with the dequant scales fused into the tile flush.

It adds no kernel: the Stream-K++ composition (``kernels/streamk/ops.py``)
runs the same B1 under the DP policy. This is the standalone entry point
the JAX package's baseline family has, where ``g = 0`` means one block per
tile.
"""

from __future__ import annotations

import torch

from repro_torch.core.policies import TileConfig
from repro_torch.kernels.dp.dp_gemm import dp_gemm_region


def gemm(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    cfg: TileConfig = TileConfig(128, 128, 128),
    g: int = 0,
    out_dtype=None,
    scale=None,
    scale_a=None,
    b_bits: int = 8,
) -> torch.Tensor:
    """``a @ b`` with the conventional output-tile decomposition.

    ``g`` > 0 launches ``g`` persistent blocks (the tuned grid size); 0 one
    block per tile. ``scale`` (N,) fuses an int8- or int4-weight op's
    per-output-channel dequant into the tile flush; ``scale_a`` (M,) its
    int8-activation per-row partner. ``b_bits == 4``: ``b`` is int4-packed
    ``(ceil(K/2), N)``; K is taken from ``a``. CPU tensors run B1's plain
    version, CUDA tensors the kernel."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"bad gemm operands {tuple(a.shape)} @ {tuple(b.shape)}")
    k_rows = (a.shape[1] + 1) // 2 if b_bits == 4 else a.shape[1]
    if b.shape[0] != k_rows:
        raise ValueError(f"bad gemm operands {tuple(a.shape)} @ {tuple(b.shape)} "
                         f"(b_bits={b_bits})")
    return dp_gemm_region(a, b, cfg, out_dtype=out_dtype or a.dtype, g=g, scale=scale,
                          scale_a=scale_a, b_bits=b_bits)
