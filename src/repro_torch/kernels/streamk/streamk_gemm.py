"""Kernels B2 and B3: the Stream-K sweep and its deterministic fix-up,
hand-written for Hopper as one kernel.

**B2 and B3 :func:`streamk_region`** replace
``src/repro/kernels/streamk/streamk_gemm.py:_streamk_kernel`` and
``_fixup_kernel``. The CUDA kernel (``streamk_kernel`` in
``csrc/stream_k.cuh``) launches ``g`` blocks; block ``x`` walks its
contiguous range of flattened MAC iterations ``[x * ipw, min((x + 1) * ipw,
total))`` with the integer math of the TPU version's
``_range_math``/``_sk_block_indices``. The TPU grid ran in order and kept
one accumulator across steps; Hopper blocks run in parallel and in no order,
so a loop inside the block takes the place of the sequential grid
dimension. A tile that one block owns whole is flushed from registers
through the epilogue straight into C (dense f32, olmoe's router, parks it in
its slot 0 and flushes that: its k-ordered map spilled when flushed from
registers). A segment of a split tile writes its f32 partial into slot
``x - first_wg(tile)`` of the ``(sk_tiles, mc + 1, bm, bn)`` workspace (the
TPU's layout; slot ``mc``, its trash slot for clamped grid steps, is never
written here) and bumps the tile's arrival counter; the last contributor to
arrive sums slots ``0..n_contrib-1`` in ascending order from 0 — the TPU
fix-up's order, so the result is deterministic, bit-identical run to run —
applies the epilogue and writes the tile into C at ``part.tile_mn(t)`` (the
TPU version wrote an ``(sk_tiles, bm, bn)`` array that ``ops`` then
scattered into C). No block waits on another, so no two need to be resident
at once, and a Stream-K region is one launch and one host call: a fix-up
launch of its own, one block per tile looping over the slots, costs launch
latency and an under-filled wave after the sweep has drained.

The quantized rungs run through the same kernel, instantiated per operand
pair (``csrc/quant_*.cu``). The partials stay f32 and unscaled whatever the
inputs (an int8 x int8 segment adds its int32 sums into them at every
``bk`` step, as the DP path does); the dequant ``scale`` and ``scale_a``
apply once, in the flush of a tile, ahead of the other epilogue stages, as
on the TPU (``streamk_gemm.py:209-216``).

What bounds it on the H100: at the serving shapes the sweep reads the
weight slice of the Stream-K region once and is bound by those bytes, like
B1 (see ``kernels/dp/dp_gemm.py``). The workspace adds
``extra_contributors * bm * bn * 4`` bytes of round trip, which the cost
model charges to split tiles. With bf16 activations (the dense, ``int8``
and ``int4`` rungs) the sub-blocks run the tensor-core mainloop of
``csrc/mma_bf16.cuh``; int8 activations (``int8-dynamic``, and int8 x
int4) the s8 tensor-core mainloop of ``csrc/mma_s8.cuh``, with the SIMT
loop's bits (each ``bk`` step's exact int32 sum added in order); f32
activations (f32, int8 or packed int4 weights) the f32 FMA mainloop of
``csrc/fma_f32.cuh`` (exact f32 products, no TF32; dense f32, olmoe's
router, in its k-ordered map). ``PERF.md`` has the times.

:func:`streamk_phase1` and :func:`streamk_fixup`, the two phases on their
own, are the plain versions of the sweep and the fix-up, and run on CPU
tensors alone; their composition is the plain version of
:func:`streamk_region`, which runs it on CPU tensors and on CUDA tensors
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.core.workpart import Partition, cdiv
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
from repro_torch.kernels.dp.dp_gemm import tile_index


def range_math(part: Partition):
    """(iters_per_tile, total SK iterations, iterations per workgroup,
    max contributors) — the static integers of the sweep and the fix-up."""
    ipt = part.iters_per_tile
    total = part.sk_total_iters
    ipw = cdiv(total, part.g) if total else 1
    return ipt, total, ipw, part.max_contributors


def n_contributors(part: Partition, device=None) -> torch.Tensor:
    """(sk_tiles,) number of workgroups that wrote a partial for each tile."""
    ipt, _, ipw, _ = range_math(part)
    t = torch.arange(part.sk_tiles, device=device)
    return ((t + 1) * ipt - 1) // ipw - (t * ipt) // ipw + 1


# --------------------------------------------------------------------------
# B2: the Stream-K sweep
# --------------------------------------------------------------------------


def streamk_phase1_plain(a, b, part: Partition, *, b_bits: int = 8) -> torch.Tensor:
    """Plain PyTorch version of B2: each workgroup's tile segments as one
    f32 product each (int8 x int8: summed per ``bk`` step, as the kernel
    does), written to their slots; unwritten slots are 0."""
    cfg = part.cfg
    ipt, _, ipw, mc = range_math(part)
    m, k = a.shape
    b = unpack_b(b, b_bits, k)
    n = b.shape[1]
    partials = torch.zeros(
        (part.sk_tiles, mc + 1, cfg.bm, cfg.bn), dtype=torch.float32, device=a.device
    )
    for r in part.sk_ranges:
        it = r.start
        while it < r.end:
            tile = it // ipt
            seg_end = min(r.end, (tile + 1) * ipt)
            k0 = (it - tile * ipt) * cfg.bk
            k1 = min((seg_end - tile * ipt) * cfg.bk, k)
            slot = min(max(r.wg - (tile * ipt) // ipw, 0), mc - 1)
            tm, tn = part.tile_mn(tile)
            rows = slice(tm * cfg.bm, min((tm + 1) * cfg.bm, m))
            cols = slice(tn * cfg.bn, min((tn + 1) * cfg.bn, n))
            blk = kstep_dot(a[rows, k0:k1], b[k0:k1, cols], cfg.bk)
            partials[tile, slot, : blk.shape[0], : blk.shape[1]] = blk
            it = seg_end
    return partials


def streamk_phase1(a, b, part: Partition, *, b_bits: int = 8) -> torch.Tensor:
    """The Stream-K sweep over CPU tensors ``a`` (M, K) @ ``b`` (K, N),
    unpadded (``b_bits=4``: ``b`` packed int4, ``(ceil(K/2), N)``); returns
    ``partials[sk_tiles, mc + 1, bm, bn]`` f32, unscaled. On the card the
    sweep and the fix-up are one kernel: CUDA tensors raise, and
    :func:`streamk_region` runs both."""
    check_b_bits(b_bits)
    if part.sk_tiles <= 0:
        raise ValueError("partition has no Stream-K region")
    if a.device.type != "cpu":
        raise ValueError("on the card the sweep runs fused with its fix-up: "
                         "call streamk_region")
    return streamk_phase1_plain(a, b, part, b_bits=b_bits)


# --------------------------------------------------------------------------
# B3: deterministic fix-up
# --------------------------------------------------------------------------


def streamk_fixup_plain(partials, part: Partition, c, *, epilogue="none", bias=None,
                        operand=None, scale=None, scale_a=None):
    """Plain PyTorch version of B3: per SK tile, the sum of its contributor
    slots, then the epilogue (dequant stages first), written into C's
    Stream-K tiles."""
    cfg = part.cfg
    m, n = c.shape
    mc1 = partials.shape[1]
    n_contrib = n_contributors(part, partials.device)
    used = torch.arange(mc1, device=partials.device)[None, :] < n_contrib[:, None]
    acc = torch.where(used[:, :, None, None], partials, 0.0).sum(dim=1)
    n_all = part.m_tiles * part.n_tiles
    grid = torch.zeros((n_all, cfg.bm, cfg.bn), dtype=torch.float32, device=c.device)
    grid[: part.sk_tiles] = acc
    full = grid.reshape(part.m_tiles, part.n_tiles, cfg.bm, cfg.bn).permute(0, 2, 1, 3)
    full = full.reshape(part.m_tiles * cfg.bm, part.n_tiles * cfg.bn)[:m, :n]
    out = apply_epilogue(full, epilogue, bias=bias, operand=operand,
                         scale=prep_scale(scale, n, 1),
                         scale_a=prep_scale_a(scale_a, m, 1)).to(c.dtype)
    sk = tile_index(m, n, cfg, c.device) < part.sk_tiles
    c.copy_(torch.where(sk, out, c))
    return c


def streamk_fixup(partials, part: Partition, c, *, epilogue="none", bias=None, operand=None,
                  scale=None, scale_a=None):
    """Reduce each Stream-K tile's contributor slots of CPU ``partials``,
    apply the epilogue (``scale_a`` (M,) and ``scale`` (N,) dequant first,
    then ``bias`` (N,) and ``operand`` (M, N)), and write the tile into
    ``c`` (M, N) in place; the data-parallel tiles of ``c`` are left alone.
    On the card the fix-up is the tail of the sweep: CUDA tensors raise, and
    :func:`streamk_region` runs both."""
    if c.device.type != "cpu" or partials.device.type != "cpu":
        raise ValueError("on the card the fix-up runs fused into the sweep: "
                         "call streamk_region")
    return streamk_fixup_plain(
        partials, part, c, epilogue=epilogue, bias=bias, operand=operand, scale=scale,
        scale_a=scale_a,
    )


# --------------------------------------------------------------------------
# B2 and B3 fused: one launch per Stream-K region
# --------------------------------------------------------------------------


def streamk_region(
    a, b, part: Partition, c, *, epilogue="none", bias=None, operand=None, scale=None,
    scale_a=None, b_bits: int = 8, workspace: bool = False,
):
    """Compute the Stream-K tiles of ``c`` (M, N) = epilogue(``a`` (M, K) @
    ``b`` (K, N)) in place (``b_bits=4``: ``b`` packed int4, ``(ceil(K/2),
    N)``), with ``scale_a`` (M,) and ``scale`` (N,) dequant first, then
    ``bias`` (N,) and ``operand`` (M, N); the data-parallel tiles of ``c``
    are left alone. Returns ``c``, or with ``workspace=True`` the pair
    ``(c, partials)``: the ``(sk_tiles, mc + 1, bm, bn)`` f32 contributor
    slots, of which the card defines those of split tiles below the tile's
    contributor count (a tile that one block owns whole is flushed from
    registers; dense f32 parks it in slot 0).

    CPU tensors run the plain version, :func:`streamk_phase1_plain` then
    :func:`streamk_fixup_plain`; CUDA tensors one launch of
    ``streamk_kernel``, counted as ``streamk_phase1`` under the rung."""
    check_b_bits(b_bits)
    if part.sk_tiles <= 0:
        raise ValueError("partition has no Stream-K region")
    epi = dict(epilogue=epilogue, bias=bias, operand=operand, scale=scale, scale_a=scale_a)
    if a.device.type == "cpu":
        partials = streamk_phase1_plain(a, b, part, b_bits=b_bits)
        streamk_fixup_plain(partials, part, c, **epi)
        return (c, partials) if workspace else c

    m, k = a.shape
    n = b.shape[1]
    scale, scale_a = f32_vector(scale, (n,)), f32_vector(scale_a, (m,))
    check_cuda_operands(a, b, c.dtype, bias, operand, b_bits=b_bits, scale=scale,
                        scale_a=scale_a)
    if tuple(c.shape) != (m, n) or c.device != a.device or not c.is_contiguous():
        raise ValueError(f"c must be a contiguous ({m}, {n}) tensor on {a.device}")
    cfg = part.cfg
    ipt, total, ipw, mc = range_math(part)
    split = mc > 1  # some tile has more than one contributor
    # dense f32 (the k-ordered map) parks whole tiles in their slot 0 too
    ordered = a.dtype == torch.float32 and b.dtype == torch.float32
    partials = counters = None
    if split or workspace or ordered:
        partials = torch.empty(
            (part.sk_tiles, mc + 1, cfg.bm, cfg.bn), dtype=torch.float32, device=a.device
        )
    if split:
        counters = arrival_counters(part.sk_tiles, a.device)
    lib = cuda_lib.library()
    bias_p, operand_p, scale_p, scale_a_p, act, binary = epilogue_args(
        epilogue, bias, operand, scale, scale_a)
    status = lib.sk_streamk_phase1(
        DTYPE_CODES[a.dtype], b_code(b, b_bits), DTYPE_CODES[c.dtype],
        sub_block_rows(cfg.bm, m), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        None if partials is None else partials.data_ptr(),
        None if counters is None else counters.data_ptr(),
        m, n, k, cfg.bm, cfg.bn, cfg.bk, part.n_tiles, ipt, ipw, total, mc,
        part.g, rows_aligned(a, b), bias_p, operand_p, scale_p, scale_a_p, act, binary,
        stream_ptr(a.device),
    )
    cuda_lib.check(status, f"streamk_region {cfg.name} g={part.g}")
    record_launch("streamk_phase1", rung_of(a.dtype, b.dtype, b_bits))
    return (c, partials) if workspace else c
