#!/usr/bin/env python3
"""Time the port's dense Hopper kernels of one checkout at decode shapes.

    python3 kernel_ab.py <tree> [--build-only]

``<tree>`` is the root of a checkout (``.`` for this one); its
``src/repro_torch`` is imported and its kernels built at first use. To
compare two commits on the same card, unpack the other one (``git
archive``) into a directory that ``.gitignore`` lists, build both with
``--build-only``, one after the other (each build already runs one nvcc
per source at once: on the 8 cores of an H100 machine one build took 229
s, two at once 553 and 583 s), and then time them in turns in one call:
parent, change, change, parent. Each run prints one JSON line of
device ms per call (calls queued behind a spin kernel, back to back, the
weights rotated past the 50 MB L2): B1 at 4x14336x4096 (DP 8x128x128), B2
and B3 at 4x4096x14336 (ALL_SK 8x256x128), all bf16, and B5 at
64x4x1024x2048 (DP 8x256x128) and 64x16x1024x2048 (ALL_SK 16x128x128) on
five operand pairs: bf16, bf16 x int8 and bf16 x packed int4 (the rungs
with bf16 activations), and as controls f32 and int8 x int8 (the
int8-dynamic rung), all with g = 132. Before it is timed, each B5 call is
held against ``gemm_grouped_streamk_plain`` (2e-2 x max|ref| for bf16
activations, 1e-4 for f32 and int8 ones); a disagreement raises.
"""

import json
import sys
import time

tree = sys.argv[1]
sys.path.insert(0, f"{tree}/src")

import torch  # noqa: E402

from repro_torch.core.policies import ALL_SK, DP, TileConfig  # noqa: E402
from repro_torch.core.quant import quantize_activations, quantize_weight  # noqa: E402
from repro_torch.core.workpart import GemmShape, partition  # noqa: E402
from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.kernels.dp.dp_gemm import dp_gemm_region  # noqa: E402
from repro_torch.kernels.streamk.grouped import (  # noqa: E402
    gemm_grouped_streamk,
    gemm_grouped_streamk_plain,
)
from repro_torch.kernels.streamk.streamk_gemm import streamk_fixup, streamk_phase1  # noqa: E402


def time_ms(fn, iters=30):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(4e8))  # cycles: keeps the card busy while the calls queue
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def b5_rungs(a, b):
    """(rung, activations, weight copies, quantized kwargs, tolerance) of
    B5's operand pairs, from bf16 ``a`` (G, M, K) and ``b`` (G, K, N).
    Quantized weights come in two copies, so that the timed calls
    alternate between them and neither stays in the L2."""
    yield "bf16", a, [b], {}, 2e-2
    for bits in (8, 4):
        qs = [quantize_weight(b, bits=bits) for _ in range(2)]
        yield f"bf16*int{bits}", a, [q.values for q in qs], dict(
            scale=qs[0].scales, b_bits=bits), 2e-2
    yield "f32", a.float(), [b.float()], {}, 1e-4
    q = quantize_weight(b, bits=8)
    qa, scale_a = quantize_activations(a)
    yield "int8*int8", qa, [q.values, q.values.clone()], dict(scale=q.scales,
                                                              scale_a=scale_a), 1e-4


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    cuda_lib.library()
    print(tree, "build", round(time.perf_counter() - t0, 1), flush=True)
    if "--build-only" in sys.argv:
        return 0
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    out = {}
    turn = iter(range(10**9))
    a, bs = randn(4, 4096), [randn(4096, 14336) for _ in range(2)]
    c = torch.empty(4, 14336, dtype=torch.bfloat16, device="cuda")
    out["B1 4x14336x4096"] = time_ms(
        lambda: dp_gemm_region(a, bs[next(turn) % 2], TileConfig(8, 128, 128), c=c, g=132))
    a, bs = randn(4, 14336), [randn(14336, 4096) for _ in range(2)]
    part = partition(GemmShape(4, 4096, 14336), TileConfig(8, 256, 128), 132, ALL_SK)
    out["B2 4x4096x14336"] = time_ms(lambda: streamk_phase1(a, bs[next(turn) % 2], part))
    partials = streamk_phase1(a, bs[0], part)
    c = torch.empty(4, 4096, dtype=torch.bfloat16, device="cuda")
    out["B3 4x4096x14336"] = time_ms(lambda: streamk_fixup(partials, part, c))
    for m, pol, cfg in ((4, DP, TileConfig(8, 256, 128)), (16, ALL_SK, TileConfig(16, 128, 128))):
        ga, gb = randn(64, m, 2048), randn(64, 2048, 1024)  # 268 MB of weights: past the L2
        for rung, a, bs, kw, tol in b5_rungs(ga, gb):
            out_dt = torch.float32 if a.dtype == torch.float32 else torch.bfloat16
            want = gemm_grouped_streamk_plain(a, bs[0], sizes=(m,) * 64, out_dtype=out_dt,
                                              bk=cfg.bk, **kw)
            got = gemm_grouped_streamk(a, bs[0], policy=pol, cfg=cfg, g=132, out_dtype=out_dt,
                                       **kw)
            err = (got.float() - want.float()).abs().max().item()
            if not err <= tol * max(1.0, want.float().abs().max().item()):
                raise AssertionError(f"B5 {rung} {pol.name} m={m}: max|err| {err:.3e}")
            key = f"B5 64x{m}x1024x2048 {pol.name}" + ("" if rung == "bf16" else f" {rung}")
            out[key] = time_ms(lambda: gemm_grouped_streamk(
                a, bs[next(turn) % len(bs)], policy=pol, cfg=cfg, g=132, out_dtype=out_dt,
                **kw))
            del want, got
    print(tree, json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
