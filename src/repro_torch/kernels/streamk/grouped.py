"""Kernel B5: the one-launch ragged grouped (MoE) GEMM, hand-written for
Hopper.

Replaces ``src/repro/kernels/streamk/grouped.py``: ``_sk_kernel`` (the
Stream-K form, ALL_SK and every HYBRID) and ``_dp_kernel`` (the DP form),
both built by ``_fused_call`` and wrapped there by ``gemm_grouped_streamk``.
The CUDA kernels are ``grouped_sk_kernel`` and ``grouped_dp_kernel`` in
``csrc/grouped.cuh`` (design notes in ``csrc/grouped.cu``). As on the TPU, one launch covers all G groups: each
group's live rows are cut into ``ceil(sizes[i] / bm)`` row-blocks, and the
concatenated row-blocks times the N tiles form one tile space of
``T = R * nt`` tiles, over which the Stream-K form spreads ``T * ipt``
MAC iterations across ``g`` blocks and the DP form strides ``g`` blocks.

Where the TPU carries a split tile's sum sequentially from one workgroup to
the next, the card's blocks run concurrently: a split tile's contributors
park their partials in a ``(g, 2, bm, bn)`` f32 workspace and the last to
arrive (an atomic counter per split tile) sums them in ascending order,
applies the epilogue and writes C. So the result is bit-identical run to
run, and the workspace is sized by ``g``, not by ``T``. The TPU wrapper pads
and concatenates A and pads B on every call; here the kernel reaches group
``i`` through its base pointers and masks rows at or past ``sizes[i]``, so
no expert weight is ever copied. The row-block -> group table is built on
the host and its device copy cached per ``(sizes, bm)``.

What bounds it on the H100: at the MoE decode shapes it reads every expert
weight once (268 MB per olmoe-1b-7b projection in bf16, 134 MB in int8, 67
MB in packed int4), so bytes bound it: 0.081, 0.041 and 0.021 ms at 3.35
TB/s. With bf16 activations (the dense, ``int8`` and ``int4`` rungs) the
kernels run the tensor-core mainloop of ``csrc/mma_bf16.cuh``:
``mma.sync`` fed by ``ldmatrix`` reads each weight from shared memory once
per block (the SIMT loop read and widened it 8 times), int8 and int4
weights are widened to bf16 once per block by a byte-permute trick (no
I2F), and 16 KB chunks keep 64 KB of weights in flight. On an H100 80GB
HBM3 at 700 W (``kernel_ab.py``, DP form at 64x4x1024x2048) that takes bf16
from 0.230 to 0.098 ms, int8 from 0.355 to 0.084 ms and int4 from 0.268 to
0.066 ms; int8 and int4 are then bound by the passes of the loop, not by
bytes. With int8 activations (the ``int8-dynamic`` rung, and int8 x int4)
they run the s8 tensor-core mainloop of ``csrc/mma_s8.cuh``
(``mma.sync.m16n8k32``, exact int32 sums per ``bk`` step, the weights
transposed into column-major strips once per block), which gives the SIMT
loop's bits: 0.270 -> 0.066 ms for int8 x int8 and 0.291 -> 0.054 ms for
int8 x int4 (same card and script). f32 activations (f32, int8 or packed
int4 weights) run the f32 FMA mainloop of ``csrc/fma_f32.cuh`` in both forms
(see ``csrc/grouped.cu``); :func:`repro_torch.kernels.common.mainloop` names
the one a call runs. A split tile's last contributor finishes it with
``fix_up_split_tile`` (``csrc/sk_common.cuh``), the tail B2 runs too.

The quantized rungs run through the same kernels, instantiated per operand
pair (``csrc/quant_*.cu``): the stacked expert weights are int8 ``(G, K, N)``
or packed int4 ``(G, ceil(K/2), N)`` with per-expert scales ``(G, N)``, and
with int8 activations the per-row scales are ``(G, M)``. Each row-block's
group picks its expert's scale row, as ``blk_group`` does on the TPU
(``repro/kernels/streamk/grouped.py:93-195``); the scales apply in the
epilogue of each tile.

On CPU tensors :func:`gemm_grouped_streamk` runs the plain PyTorch version
:func:`gemm_grouped_streamk_plain`; on CUDA tensors it launches the kernel
or raises.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.policies import ALL_SK, Policy, PolicyKind, TileConfig
from repro_torch.core.workpart import cdiv
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.common import (
    DTYPE_CODES,
    apply_epilogue,
    arrival_counters,
    b_code,
    check_b_bits,
    check_cuda_operands,
    epilogue_args,
    f32_vector,
    hold,
    kstep_dot,
    record_launch,
    rows_aligned,
    rung_of,
    stream_ptr,
    sub_block_rows,
    unpack_b,
)


def row_block_table(sizes: Tuple[int, ...], bm: int) -> np.ndarray:
    """(R, 3) int32: for each row-block of the concatenated space, its group,
    its first row within the group and the row it ends before. Empty groups
    own no row-block."""
    rows = [
        (i, r0, min(s, r0 + bm))
        for i, s in enumerate(sizes)
        for r0 in range(0, s, bm)
    ]
    return np.asarray(rows, np.int32).reshape(-1, 3)


@lru_cache(maxsize=256)
def _table(sizes, bm: int, device) -> torch.Tensor:
    """The row-block table's device copy, kept per (sizes, bm, device): a
    decode step dispatches the same few grouped shapes every layer, and a
    copy per call would be a host-to-device transfer per call. A captured
    step holds the tables it reads (``hold``), so an eviction frees none of
    them while the graph lives."""
    return torch.from_numpy(row_block_table(sizes, bm)).to(device)


def gemm_grouped_streamk_plain(
    a, b, *, sizes, out_dtype, epilogue="none", bias=None, operand=None, scale=None,
    scale_a=None, b_bits: int = 8, bk: int = 128,
) -> torch.Tensor:
    """Plain PyTorch version of B5: per group, an f32-accumulated
    ``a[i, :s] @ b[i]`` (int8 x int8 summed per ``bk`` step, as the kernel
    does) and the epilogue, dequant stages first; rows past a group's size
    are 0."""
    g_count, m, k = a.shape
    n = b.shape[2]
    c = torch.zeros((g_count, m, n), dtype=out_dtype, device=a.device)
    for i, s in enumerate(sizes):
        if s == 0:
            continue
        acc = kstep_dot(a[i, :s], unpack_b(b[i], b_bits, k), bk)
        c[i, :s] = apply_epilogue(
            acc, epilogue,
            bias=None if bias is None else bias[i],
            operand=None if operand is None else operand[i, :s],
            scale=None if scale is None else scale[i].reshape(1, n),
            scale_a=None if scale_a is None else scale_a[i, :s].reshape(s, 1),
        ).to(out_dtype)
    return c


def gemm_grouped_streamk(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    policy: Policy = ALL_SK,
    cfg: TileConfig = TileConfig(128, 128, 128),
    g: int = 8,
    out_dtype=None,
    epilogue="none",
    bias: Optional[torch.Tensor] = None,
    operand: Optional[torch.Tensor] = None,
    scale=None,
    scale_a=None,
    group_sizes: Optional[Tuple[int, ...]] = None,
    b_bits: int = 8,
) -> torch.Tensor:
    """Grouped GEMM ``c[i] = a[i] @ b[i]`` in ONE kernel launch.

    a: (G, M, K), b: (G, K, N) -> (G, M, N) in ``out_dtype`` (default
    ``a.dtype``). ``group_sizes`` (default ``(M,) * G``) gives each group's
    real row count: only the first ``sizes[i]`` rows take part, the output
    rows past them are 0, and an empty group contributes no tile. With no
    row at all nothing launches. ``bias`` (G, N) and ``operand`` (G, M, N)
    feed the per-group epilogue, after the quantized rungs' dequant stages:
    ``b`` int8 (or, with ``b_bits=4``, packed int4 ``(G, ceil(K/2), N)``)
    with per-expert ``scale`` (G, N), and for int8 activations per-row
    ``scale_a`` (G, M). Policies other than DP run the Stream-K form."""
    k_rows = (a.shape[-1] + 1) // 2 if b_bits == 4 else a.shape[-1]
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] or b.shape[1] != k_rows:
        raise ValueError(f"bad grouped operands {tuple(a.shape)} @ {tuple(b.shape)} "
                         f"(b_bits={b_bits})")
    check_b_bits(b_bits)
    g_count, m, k = a.shape
    n = b.shape[2]
    out_dtype = out_dtype or a.dtype
    sizes = tuple(int(s) for s in group_sizes) if group_sizes is not None else (m,) * g_count
    if len(sizes) != g_count or any(s < 0 or s > m for s in sizes):
        raise ValueError(f"bad group_sizes {sizes} for M={m}, G={g_count}")
    r_total = sum(cdiv(s, cfg.bm) for s in sizes)
    if r_total == 0:
        return torch.zeros((g_count, m, n), dtype=out_dtype, device=a.device)
    if a.device.type == "cpu":
        return gemm_grouped_streamk_plain(
            a, b, sizes=sizes, out_dtype=out_dtype, epilogue=epilogue, bias=bias,
            operand=operand, scale=scale, scale_a=scale_a, b_bits=b_bits, bk=cfg.bk,
        )

    scale = f32_vector(scale, (g_count, n))
    scale_a = f32_vector(scale_a, (g_count, m))
    check_cuda_operands(a, b, out_dtype, bias, operand, b_bits=b_bits, scale=scale,
                        scale_a=scale_a)
    nt = cdiv(n, cfg.bn)
    ipt = cdiv(k, cfg.bk)
    n_tiles = r_total * nt
    sk_form = policy.kind != PolicyKind.DP
    # a short group leaves rows the kernel never writes: they must read 0
    ragged = any(s < m for s in sizes)
    c = (torch.zeros if ragged else torch.empty)((g_count, m, n), dtype=out_dtype,
                                                 device=a.device)
    ws = counters = None
    if sk_form:
        ipw = cdiv(n_tiles * ipt, g)
        grid = g
        if ipw % ipt:  # some workgroup boundary falls inside a tile
            ws = torch.empty((g, 2, cfg.bm, cfg.bn), dtype=torch.float32, device=a.device)
            counters = arrival_counters(g, a.device)
    else:
        ipw = ipt
        grid = min(g, n_tiles)
    lib = cuda_lib.library()
    bias_p, operand_p, scale_p, scale_a_p, act, binary = epilogue_args(
        epilogue, bias, operand, scale, scale_a)
    status = lib.sk_grouped_gemm(
        DTYPE_CODES[a.dtype], b_code(b, b_bits), DTYPE_CODES[out_dtype],
        sub_block_rows(cfg.bm, m), int(sk_form),
        a.data_ptr(), b.data_ptr(), c.data_ptr(),
        hold(_table(sizes, cfg.bm, a.device)).data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if counters is None else counters.data_ptr(),
        m, n, k, cfg.bm, cfg.bn, cfg.bk, nt, n_tiles, ipt, ipw, grid, rows_aligned(a, b),
        bias_p, operand_p, scale_p, scale_a_p, act, binary, stream_ptr(a.device),
    )
    name = "grouped_streamk_sk" if sk_form else "grouped_streamk_dp"
    cuda_lib.check(status, f"{name} {cfg.name} g={g}")
    record_launch(name, rung_of(a.dtype, b.dtype, b_bits))
    return c
