"""Public wrapper for the split-K baseline (counterpart of
``repro.kernels.splitk.ops``): B6's partials, their reduction and the
dequant scales.

Split-K has no served caller: it is the kernel-library baseline that the
paper's Stream-K generalises, compared beside the Stream-K++ pick, DP and
``torch.matmul`` at full width by ``chip_smoke.py``.
"""

from __future__ import annotations

import torch

from repro_torch.core.policies import TileConfig
from repro_torch.kernels.splitk.splitk_gemm import splitk_partials


def gemm(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    cfg: TileConfig = TileConfig(128, 128, 128),
    s: int = 2,
    g: int = 0,
    out_dtype=None,
    scale=None,
    scale_a=None,
    b_bits: int = 8,
) -> torch.Tensor:
    """``a @ b`` with a fixed split-K factor ``s``. ``g`` > 0 launches the
    tile dimension over ``g`` blocks (the tuned grid size), 0 one block per
    tile. ``scale`` (N,) is an int8- or int4-weight op's per-output-channel
    dequant vector and ``scale_a`` (M,) its int8-activation per-row
    partner; split-K's epilogue IS the partial-sum reduction, so both apply
    there, once, after the splits combine. ``b_bits == 4``: ``b`` is
    int4-packed ``(ceil(K/2), N)``; K comes from ``a``.

    The reduction is the one ``repro`` leaves to XLA outside its kernel: a
    plain f32 sum over the splits (deterministic), then ``scale_a`` (rows),
    then ``scale`` (columns), then the cast to ``out_dtype`` (default
    ``a.dtype``). CPU tensors run B6's plain version, CUDA tensors the
    kernel."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"bad gemm operands {tuple(a.shape)} @ {tuple(b.shape)}")
    k_rows = (a.shape[1] + 1) // 2 if b_bits == 4 else a.shape[1]
    if b.shape[0] != k_rows:
        raise ValueError(f"bad gemm operands {tuple(a.shape)} @ {tuple(b.shape)} "
                         f"(b_bits={b_bits})")
    m, n = a.shape[0], b.shape[1]
    out_dtype = out_dtype or a.dtype
    c = splitk_partials(a, b, cfg, s, g=g, b_bits=b_bits).sum(dim=0)
    if scale_a is not None:
        c = c * scale_a.reshape(m, 1).to(torch.float32)
    if scale is not None:
        c = c * scale.reshape(1, n).to(torch.float32)
    return c.to(out_dtype)
