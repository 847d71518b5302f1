"""Kernels B2 and B3: the Stream-K sweep and its deterministic fix-up,
hand-written for Hopper.

**B2 :func:`streamk_phase1`** replaces
``src/repro/kernels/streamk/streamk_gemm.py:_streamk_kernel``. The CUDA
kernel (``streamk_kernel`` in ``csrc/stream_k.cu``) launches ``g`` blocks;
block ``x`` walks its contiguous range of flattened MAC iterations
``[x * ipw, min((x + 1) * ipw, total))`` with the integer math of the TPU
version's ``_range_math``/``_sk_block_indices`` and writes each tile
segment's f32 partial into slot ``clip(x - first_wg(tile), 0, mc - 1)`` of
the ``(sk_tiles, mc + 1, bm, bn)`` workspace. The TPU grid ran in order and
kept one accumulator across steps; Hopper blocks run in parallel and in no
order, so a loop inside the block takes the place of the sequential grid
dimension, and the disjoint slots take the place of GPU atomics. Slot
``mc`` (the TPU's trash slot for clamped grid steps) is never written here.

**B3 :func:`streamk_fixup`** replaces ``_fixup_kernel`` of the same file.
One block per Stream-K tile sums slots ``0..n_contrib-1`` in ascending
order — so the result is deterministic, bit-identical run to run — applies
the epilogue, and writes the tile straight into C at ``part.tile_mn(t)``
(the TPU version wrote an ``(sk_tiles, bm, bn)`` array that ``ops`` then
scattered into C with reshapes).

The quantized rungs run through the same kernels, instantiated per operand
pair (``csrc/quant_*.cu``). B2's partials stay f32 and unscaled whatever
the inputs (an int8 x int8 segment adds its int32 sums into them at every
``bk`` step, as the DP path does); the dequant ``scale`` and ``scale_a``
apply once, in B3, ahead of the other epilogue stages, as on the TPU
(``streamk_gemm.py:209-216``).

What bounds them on the H100: at the serving shapes B2 reads the weight
slice of the Stream-K region once and is bound by those bytes, like B1 (see
``kernels/dp/dp_gemm.py``); B3 is bound by reading the partial slots and
writing C. The workspace adds ``extra_contributors * bm * bn * 4`` bytes of
round trip, which the cost model charges to split tiles; keeping the sweep
and the fix-up two launches keeps the sum order fixed without flags or
atomics. With bf16 activations (the dense, ``int8`` and ``int4`` rungs)
B2's sub-blocks run the tensor-core mainloop of ``csrc/mma_bf16.cuh`` and
park their fragments in the same row-major f32 slots, so B3 reads what it
read before. On an H100 80GB HBM3 at 700 W (``kernel_ab.py``,
4x4096x14336, ALL_SK 8x256x128, g 132) B2 takes 0.045 / 0.037 / 0.028 ms
on bf16 / int8 / int4 (SIMT: 0.103 / 0.168 / 0.112) and B3 0.007 ms. int8
activations (``int8-dynamic``, and int8 x int4) run the s8 tensor-core
mainloop of ``csrc/mma_s8.cuh`` over each segment and park into the same
slots, with the SIMT loop's bits (each ``bk`` step's exact int32 sum added
in order); f32 activations keep SIMT FMA (no TF32).

On CPU tensors the wrappers run the plain PyTorch versions beside them; on
CUDA tensors they launch the kernels or raise.
"""

from __future__ import annotations

import torch

from repro_torch.core.workpart import Partition, cdiv
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
from repro_torch.kernels.dp.dp_gemm import tile_index


def range_math(part: Partition):
    """(iters_per_tile, total SK iterations, iterations per workgroup,
    max contributors) — the static integers both kernels share."""
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
    """Run the Stream-K sweep over ``a`` (M, K) @ ``b`` (K, N), unpadded
    (``b_bits=4``: ``b`` packed int4, ``(ceil(K/2), N)``); returns
    ``partials[sk_tiles, mc + 1, bm, bn]`` f32, unscaled. On the card, slots
    at or past a tile's contributor count hold whatever the allocator left
    there: only :func:`streamk_fixup`'s ``n_contrib`` slots are defined."""
    check_b_bits(b_bits)
    if part.sk_tiles <= 0:
        raise ValueError("partition has no Stream-K region")
    if a.device.type == "cpu":
        return streamk_phase1_plain(a, b, part, b_bits=b_bits)

    check_cuda_operands(a, b, torch.float32, None, None, b_bits=b_bits)
    cfg = part.cfg
    ipt, total, ipw, mc = range_math(part)
    m, k = a.shape
    n = b.shape[1]
    partials = torch.empty(
        (part.sk_tiles, mc + 1, cfg.bm, cfg.bn), dtype=torch.float32, device=a.device
    )
    lib = cuda_lib.library()
    status = lib.sk_streamk_phase1(
        DTYPE_CODES[a.dtype], b_code(b, b_bits), sub_block_rows(cfg.bm, m),
        a.data_ptr(), b.data_ptr(), partials.data_ptr(),
        m, n, k, cfg.bm, cfg.bn, cfg.bk, part.n_tiles, ipt, ipw, total, mc,
        part.g, rows_aligned(a, b), stream_ptr(a.device),
    )
    cuda_lib.check(status, f"streamk_phase1 {cfg.name} g={part.g}")
    record_launch("streamk_phase1", rung_of(a.dtype, b.dtype, b_bits))
    return partials


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


def streamk_fixup(
    partials, part: Partition, c, *, epilogue="none", bias=None, operand=None,
    scale=None, scale_a=None, rung=None,
):
    """Reduce each Stream-K tile's contributor slots, apply the epilogue
    (``scale_a`` (M,) and ``scale`` (N,) dequant first, then ``bias`` (N,)
    and ``operand`` (M, N)), and write the tile into ``c`` (M, N) in place;
    the data-parallel tiles of ``c`` are left alone. ``rung`` names the
    quantization rung whose partials these are, for the launch count."""
    if c.device.type == "cpu":
        return streamk_fixup_plain(
            partials, part, c, epilogue=epilogue, bias=bias, operand=operand,
            scale=scale, scale_a=scale_a,
        )

    cfg = part.cfg
    ipt, _, ipw, mc = range_math(part)
    m, n = c.shape
    expect = (part.sk_tiles, mc + 1, cfg.bm, cfg.bn)
    if tuple(partials.shape) != expect or partials.dtype != torch.float32:
        raise ValueError(f"partials must be {expect} float32, got {tuple(partials.shape)}")
    if not (partials.is_contiguous() and c.is_contiguous()):
        raise ValueError("partials and c must be contiguous")
    if partials.device != c.device or c.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("partials and c must share a CUDA device; c f32 or bf16")
    scale, scale_a = f32_vector(scale, (n,)), f32_vector(scale_a, (m,))
    for name, t, shape, dtype in (("bias", bias, (n,), c.dtype),
                                  ("operand", operand, (m, n), c.dtype),
                                  ("scale", scale, (n,), torch.float32),
                                  ("scale_a", scale_a, (m,), torch.float32)):
        if t is not None and (
            tuple(t.shape) != shape or t.dtype != dtype or t.device != c.device
            or not t.is_contiguous()
        ):
            raise ValueError(f"{name} must be a contiguous {shape} {dtype} tensor")
    lib = cuda_lib.library()
    bias_p, operand_p, scale_p, scale_a_p, act, binary = epilogue_args(
        epilogue, bias, operand, scale, scale_a)
    status = lib.sk_streamk_fixup(
        DTYPE_CODES[c.dtype], partials.data_ptr(), c.data_ptr(),
        m, n, cfg.bm, cfg.bn, part.n_tiles, ipt, ipw, mc, part.sk_tiles,
        bias_p, operand_p, scale_p, scale_a_p, act, binary, stream_ptr(c.device),
    )
    cuda_lib.check(status, f"streamk_fixup {cfg.name}")
    record_launch("streamk_fixup", rung)
    return c

