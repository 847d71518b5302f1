#!/usr/bin/env python3
"""Time the port's dense Hopper kernels of one checkout at decode shapes.

    python3 kernel_ab.py <tree> [--build-only]

``<tree>`` is the root of a checkout (``.`` for this one); its
``src/repro_torch`` is imported and its kernels built at first use. To
compare two commits on the same card, unpack the other one (``git
archive``) into a directory that ``.gitignore`` lists, build both (the
``--build-only`` runs may go in parallel) and then time them in turns in
one call: parent, change, change, parent. Each run prints one JSON line of
device ms per call (calls queued behind a spin kernel, back to back, the
weights rotated past the 50 MB L2): B1 at 4x14336x4096 (DP 8x128x128), B2
and B3 at 4x4096x14336 (ALL_SK 8x256x128), B5 at 64x4x1024x2048 (DP
8x256x128) and 64x16x1024x2048 (ALL_SK 16x128x128), all bf16 with g = 132.
"""

import json
import sys
import time

tree = sys.argv[1]
sys.path.insert(0, f"{tree}/src")

import torch  # noqa: E402

from repro_torch.core.policies import ALL_SK, DP, TileConfig  # noqa: E402
from repro_torch.core.workpart import GemmShape, partition  # noqa: E402
from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.kernels.dp.dp_gemm import dp_gemm_region  # noqa: E402
from repro_torch.kernels.streamk.grouped import gemm_grouped_streamk  # noqa: E402
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
        out[f"B5 64x{m}x1024x2048 {pol.name}"] = time_ms(
            lambda: gemm_grouped_streamk(ga, gb, policy=pol, cfg=cfg, g=132))
    print(tree, json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
