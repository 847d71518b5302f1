"""Plain oracles for the Stream-K++ GEMM (counterpart of
``repro.kernels.streamk.ref``): whatever the policy, the result must equal an
f32-accumulated matmul, and the partials workspace must equal Algorithm 1
computed iteration by iteration."""

from __future__ import annotations

import torch

from repro_torch.core.workpart import Partition


def gemm_ref(a, b, out_dtype=None):
    """f32-accumulated ``a @ b`` cast to ``out_dtype`` (defaults to a.dtype)."""
    out_dtype = out_dtype or a.dtype
    return torch.matmul(a.to(torch.float32), b.to(torch.float32)).to(out_dtype)


def streamk_partition_ref(a, b, part: Partition):
    """Algorithm 1 one k-iteration at a time: every workgroup's partial
    contributions, then their sum per tile. ``a``/``b`` are padded to tile
    multiples. Returns (partials[sk_tiles, mc+1, bm, bn], c_sk[sk_tiles, bm, bn])."""
    cfg = part.cfg
    ipt = part.iters_per_tile
    mc = part.max_contributors
    ipw = max(1, -(-part.sk_total_iters // part.g))
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    partials = torch.zeros((part.sk_tiles, mc + 1, cfg.bm, cfg.bn), dtype=torch.float32)
    for r in part.sk_ranges:
        for it in range(r.start, r.end):
            tile, local_k = it // ipt, it % ipt
            tm, tn = part.tile_mn(tile)
            slot = min(max(r.wg - (tile * ipt) // ipw, 0), mc - 1)
            ks = slice(local_k * cfg.bk, (local_k + 1) * cfg.bk)
            a_blk = a[tm * cfg.bm : (tm + 1) * cfg.bm, ks]
            b_blk = b[ks, tn * cfg.bn : (tn + 1) * cfg.bn]
            partials[tile, slot] += a_blk @ b_blk
    return partials, partials.sum(dim=1)
