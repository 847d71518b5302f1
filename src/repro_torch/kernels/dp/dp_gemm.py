"""Kernel B1: the data-parallel tiled GEMM region, hand-written for Hopper.

Replaces ``src/repro/kernels/dp/dp_gemm.py:_dp_kernel`` (launched there by
``dp_gemm_region``). The CUDA kernels are in ``csrc/stream_k.cuh``:
``dp_fma_kernel`` for f32 activations, ``dp_mma_kernel`` for bf16 ones,
``dp_s8_kernel`` for int8 ones. ``g`` persistent blocks (one per tile when
``g == 0``) stride over the output tiles ``[tile_offset, m_tiles *
n_tiles)``; each logical ``bm x bn`` tile is walked in sub-blocks whose K
loop is staged through shared memory, and the epilogue runs on the f32
accumulator before the cast. On the TPU the surplus programs of a
wave-padded grid clamp onto the last tile; here a block whose stride runs
past the last tile simply stops, which writes the same C.

The quantized rungs run through the same kernel, instantiated per operand
pair (``csrc/quant_*.cu``): float activations against int8 or packed int4
weights, and int8 activations against either with an int32 MAC. The
dequant ``scale`` (per column) and ``scale_a`` (per row) apply once, at the
flush, ahead of the other epilogue stages, as on the TPU
(``dp_gemm.py:79-88``).

What bounds it on the H100: at the serving shapes (M = slot count, or a
prompt of a few dozen tokens, against 4096..49152-wide weights) the work is
far below the card's 295 operations per byte, so it is bound by reading B
from device memory. The design never pads or copies a weight (the kernel
masks ragged M, N and K edges itself), and picks the sub-block height from
M so a decode GEMM does not compute padded rows. With bf16 activations (the
dense, ``int8`` and ``int4`` rungs) each sub-block runs the tensor-core
mainloop of ``csrc/mma_bf16.cuh``: ``mma.sync`` fed by ``ldmatrix`` reads
each weight from shared memory once per block, and int8 and int4 weights
are widened to bf16 once per block, exactly. On an H100 80GB HBM3 at 700 W
(``kernel_ab.py``, 4x14336x4096, DP 8x128x128, g 132) that takes bf16 from
0.114 to 0.044 ms (its bound is 0.035), int8 from 0.177 to 0.038 and int4
from 0.133 to 0.034 ms. int8 activations (the ``int8-dynamic`` rung, and
int8 x int4) run the s8 tensor-core mainloop of ``csrc/mma_s8.cuh``
(``dp_s8_kernel``): ``mma.sync`` on the int8 codes, each ``bk`` step's
exact int32 sum added into the f32 accumulator in the SIMT loop's order, so
C with the dequant scales alone is the plain version's, bit for bit. f32
activations (f32, int8 or packed int4 weights) run the f32 FMA mainloop of
``csrc/fma_f32.cuh`` (``dp_fma_kernel``): exact f32 products (no TF32),
each weight read from shared memory and widened once per block, the K
slices of a warp summed by a fixed shuffle tree (1e-4 against the plain
version, the same bits run to run).
:func:`repro_torch.kernels.common.mainloop` names the loop a call runs.

On a CPU tensor :func:`dp_gemm_region` runs the plain PyTorch version
:func:`dp_gemm_region_plain`, which the tests and ``chip_smoke.py`` hold the
kernel against; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.policies import TileConfig
from repro_torch.core.workpart import cdiv
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.common import (
    DTYPE_CODES,
    apply_epilogue,
    b_code,
    check_b_bits,
    check_cuda_operands,
    epilogue_args,
    f32_vector,
    kstep_dot,
    prep_scale,
    prep_scale_a,
    record_launch,
    rows_aligned,
    rung_of,
    stream_ptr,
    sub_block_rows,
    unpack_b,
)


def tile_index(m: int, n: int, cfg: TileConfig, device) -> torch.Tensor:
    """(M, N) map of each element's row-major output-tile index."""
    nt = cdiv(n, cfg.bn)
    rows = torch.arange(m, device=device) // cfg.bm
    cols = torch.arange(n, device=device) // cfg.bn
    return rows[:, None] * nt + cols[None, :]


def dp_gemm_region_plain(
    a, b, cfg: TileConfig, c, *, tile_offset=0, epilogue="none", bias=None, operand=None,
    scale=None, scale_a=None, b_bits: int = 8,
):
    """Plain PyTorch version of B1: C tiles ``>= tile_offset`` become
    epilogue(A @ B) with f32 accumulation (int8 x int8 summed per ``bk``
    step, as the kernel does) and the dequant stages first; the other tiles
    keep C's values."""
    m, k = a.shape
    n = b.shape[1]
    acc = kstep_dot(a, unpack_b(b, b_bits, k), cfg.bk)
    out = apply_epilogue(acc, epilogue, bias=bias, operand=operand,
                         scale=prep_scale(scale, n, 1), scale_a=prep_scale_a(scale_a, m, 1))
    out = out.to(c.dtype)
    if tile_offset == 0:
        c.copy_(out)
    else:
        keep = tile_index(c.shape[0], c.shape[1], cfg, c.device) < tile_offset
        c.copy_(torch.where(keep, c, out))
    return c


def dp_gemm_region(
    a: torch.Tensor,
    b: torch.Tensor,
    cfg: TileConfig,
    *,
    c: Optional[torch.Tensor] = None,
    tile_offset: int = 0,
    out_dtype=None,
    epilogue="none",
    bias=None,
    operand=None,
    scale=None,
    scale_a=None,
    b_bits: int = 8,
    g: int = 0,
) -> torch.Tensor:
    """Tiled GEMM over output tiles ``[tile_offset, m_tiles * n_tiles)``.

    ``a`` (M, K) and ``b`` (K, N) are NOT padded; with ``b_bits=4`` ``b`` is
    packed int4, ``(ceil(K/2), N)``. ``c`` (M, N) is written in place for
    the region's tiles (allocated when None — then ``tile_offset`` must be
    0); tiles below ``tile_offset`` keep what the Stream-K region wrote
    there. ``bias`` (N,) and ``operand`` (M, N) feed the epilogue, after
    the dequant ``scale_a`` (M,) and ``scale`` (N,). ``g`` > 0 is the number
    of persistent blocks (the selected grid size); 0 launches one block per
    tile."""
    check_b_bits(b_bits)
    m, k = a.shape
    n = b.shape[1]
    out_dtype = out_dtype or (a.dtype if c is None else c.dtype)
    if c is None:
        if tile_offset:
            raise ValueError("tile_offset > 0 needs the C that holds the lower tiles")
        c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    elif tuple(c.shape) != (m, n) or c.dtype != out_dtype or not c.is_contiguous():
        raise ValueError(f"c must be a contiguous ({m}, {n}) {out_dtype} tensor")
    n_tiles_n = cdiv(n, cfg.bn)
    n_total = cdiv(m, cfg.bm) * n_tiles_n
    n_region = n_total - tile_offset
    if n_region <= 0:
        raise ValueError("empty DP region")

    if a.device.type == "cpu":
        return dp_gemm_region_plain(
            a, b, cfg, c, tile_offset=tile_offset, epilogue=epilogue,
            bias=bias, operand=operand, scale=scale, scale_a=scale_a, b_bits=b_bits,
        )

    scale, scale_a = f32_vector(scale, (n,)), f32_vector(scale_a, (m,))
    check_cuda_operands(a, b, out_dtype, bias, operand, b_bits=b_bits, scale=scale,
                        scale_a=scale_a)
    lib = cuda_lib.library()
    bias_p, operand_p, scale_p, scale_a_p, act, binary = epilogue_args(
        epilogue, bias, operand, scale, scale_a)
    grid = min(g, n_region) if g > 0 else n_region
    status = lib.sk_dp_gemm(
        DTYPE_CODES[a.dtype], b_code(b, b_bits), DTYPE_CODES[out_dtype],
        sub_block_rows(cfg.bm, m), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        m, n, k, cfg.bm, cfg.bn, cfg.bk, n_tiles_n, tile_offset, n_total, grid,
        rows_aligned(a, b), bias_p, operand_p, scale_p, scale_a_p, act, binary,
        stream_ptr(a.device),
    )
    cuda_lib.check(status, f"dp_gemm_region {cfg.name}")
    record_launch("dp_gemm_region", rung_of(a.dtype, b.dtype, b_bits))
    return c
