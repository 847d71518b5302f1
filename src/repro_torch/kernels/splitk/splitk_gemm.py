"""Kernel B6: the fixed-factor split-K GEMM's partials, hand-written for
Hopper.

Replaces ``src/repro/kernels/splitk/splitk_gemm.py:_splitk_kernel``
(launched there by ``splitk_partials``), the strategy that Stream-K
generalises (§2 of the paper): K is cut into ``s`` splits of ``kps =
ceil(ceil(K / bk) / s)`` k-steps, each split of each output tile computes
its own f32 partial, and the caller reduces over the splits. Split ``sp``
covers ``k`` in ``[sp * kps * bk, (sp + 1) * kps * bk)`` cut to ``[0, K)``,
the TPU version's boundaries.

The CUDA kernels are in ``csrc/splitk.cuh``, one per mainloop (below). The TPU pads A
and B up to whole tiles and K up to ``bk * s`` and returns padded
``(s, Mp, Np)`` partials; here nothing is padded or copied (the loads mask
the ragged M, N and K edges) and the partials are ``(s, M, N)``. A split
whose range lies past K (K < ``bk * s``) writes zeros, as the TPU's
zero-padded split does. The grid is ``(g or n_tiles) x s``: block ``(x,
sp)`` strides over tiles ``x, x + g, ...`` of split ``sp``, so every
``(tile, split)`` partial is written by exactly one block and the result is
bit-identical run to run. (On the TPU, ``g`` pads the tile dimension up to
whole waves of ``g`` programs whose surplus recomputes the last tile; the
partials are the same.)

Every operand pair is instantiated (``csrc/stream_k.cu``, and
``csrc/quant_*.cu`` for the ladder's), and each sub-block runs the mainloop
B1 runs for its activations (:func:`repro_torch.kernels.common.mainloop`):
bf16 activations (x bf16, int8 or packed int4) ``splitk_mma_kernel`` on the
tensor cores of ``csrc/mma_bf16.cuh``; int8 activations (x int8 or packed
int4) ``splitk_s8_kernel`` on the s8 tensor cores of ``csrc/mma_s8.cuh``,
whose exact int32 sums enter the f32 partial at every ``bk`` step (a split
starts on one), so its partials are the plain version's bit for bit; f32
activations ``splitk_fma_kernel`` on the f32 FMA mainloop of
``csrc/fma_f32.cuh`` (exact f32 products, no TF32, each weight read from
shared memory and widened once per block). The partials are unscaled:
:func:`repro_torch.kernels.splitk.ops.gemm` applies the dequant scales
once, after the reduction, as ``repro``'s ``ops.gemm`` does.

What bounds it on the H100: at the decode shapes it reads B once and
writes ``s * M * N * 4`` bytes of partials, both at a few operations per
byte, so bytes bound it.

On a CPU tensor :func:`splitk_partials` runs the plain PyTorch version
:func:`splitk_partials_plain`, which the tests and ``chip_smoke.py`` hold
the kernel against; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.core.policies import TileConfig
from repro_torch.core.workpart import cdiv
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.common import (
    DTYPE_CODES,
    b_code,
    check_b_bits,
    check_cuda_operands,
    kstep_dot,
    record_launch,
    rows_aligned,
    rung_of,
    stream_ptr,
    sub_block_rows,
    unpack_b,
)


def k_per_split(k: int, bk: int, s: int) -> int:
    """k-steps per split: ``ceil(ceil(K / bk) / s)`` (the TPU's ``kps`` once
    K is padded up to ``bk * s``)."""
    return cdiv(cdiv(k, bk), s)


def splitk_partials_plain(a, b, cfg: TileConfig, s: int, *, b_bits: int = 8) -> torch.Tensor:
    """Plain PyTorch version of B6: split ``sp``'s f32 product over its K
    range (int8 activations: summed per ``bk`` step, as the kernel does);
    an empty split is 0."""
    m, k = a.shape
    b = unpack_b(b, b_bits, k)
    span = k_per_split(k, cfg.bk, s) * cfg.bk
    parts = torch.zeros((s, m, b.shape[1]), dtype=torch.float32, device=a.device)
    for sp in range(s):
        k0, k1 = sp * span, min((sp + 1) * span, k)
        if k0 < k1:
            parts[sp] = kstep_dot(a[:, k0:k1], b[k0:k1], cfg.bk)
    return parts


def splitk_partials(
    a: torch.Tensor,
    b: torch.Tensor,
    cfg: TileConfig,
    s: int,
    *,
    g: int = 0,
    b_bits: int = 8,
) -> torch.Tensor:
    """Split-K partials of ``a`` (M, K) @ ``b`` (K, N), unpadded (with
    ``b_bits=4`` ``b`` is packed int4, ``(ceil(K/2), N)``): returns
    ``(s, M, N)`` f32, unscaled; the caller sums over dim 0. ``g`` > 0 is
    the number of blocks over the tiles (the tuned grid size); 0 launches
    one per tile."""
    check_b_bits(b_bits)
    if s < 1:
        raise ValueError(f"split factor s must be >= 1, got {s}")
    if a.device.type == "cpu":
        return splitk_partials_plain(a, b, cfg, s, b_bits=b_bits)

    check_cuda_operands(a, b, torch.float32, None, None, b_bits=b_bits)
    m, k = a.shape
    n = b.shape[1]
    n_tiles_n = cdiv(n, cfg.bn)
    n_total = cdiv(m, cfg.bm) * n_tiles_n
    parts = torch.empty((s, m, n), dtype=torch.float32, device=a.device)
    lib = cuda_lib.library()
    status = lib.sk_splitk_partials(
        DTYPE_CODES[a.dtype], b_code(b, b_bits), sub_block_rows(cfg.bm, m),
        a.data_ptr(), b.data_ptr(), parts.data_ptr(),
        m, n, k, cfg.bm, cfg.bn, cfg.bk, n_tiles_n, n_total, k_per_split(k, cfg.bk, s), s,
        min(g, n_total) if g > 0 else n_total, rows_aligned(a, b), stream_ptr(a.device),
    )
    cuda_lib.check(status, f"splitk_partials {cfg.name} s={s} g={g}")
    record_launch("splitk_partials", rung_of(a.dtype, b.dtype, b_bits))
    return parts
