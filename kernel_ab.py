#!/usr/bin/env python3
"""Time the port's dense Hopper kernels of one checkout at decode shapes.

    python3 kernel_ab.py <tree> [--build-only] [--out FILE]
    python3 kernel_ab.py --report FILE

``<tree>`` is the root of a checkout (``.`` for this one); its
``src/repro_torch`` is imported and its kernels built at first use. To
compare two commits on the same card, unpack the other one (``git
archive``) into a directory that ``.gitignore`` lists, build both with
``--build-only``, one after the other (each build already runs one nvcc
per source at once: on the 8 cores of an H100 machine one build took 229
s, two at once 553 and 583 s), and then time them in turns in one call:
parent, change, change, parent, each with ``--out FILE``. Each run prints
one JSON line of device ms per call (calls queued behind a spin kernel,
back to back, the weights rotated through copies that together pass 200
MB, four times the 50 MB L2), one of the mainloop each kernel runs per
operand pair (``repro_torch.kernels.common.mainloop``; null for a tree that
predates it) and one of a digest of the output bytes of each checked call
(sha256, first 16 hex digits); with ``--out`` it also appends all three as
one JSON record to FILE. ``--report FILE`` then prints, per kernel and
pair, each tree's times, the ratio of the mean times and whether every run
of every tree gave the same output bytes. Timed: B1 at 4x14336x4096 (DP
8x128x128), B2, B3 and their composition B2+B3 at 4x4096x14336 (ALL_SK
8x256x128), and B5 at 64x4x1024x2048 (DP 8x256x128) and 64x16x1024x2048
(ALL_SK 16x128x128), all with g = 132, and B6 at 4x14336x4096 (split-K s =
4, 8x128x128, g = 0, one block per tile), each on six operand pairs: bf16,
bf16 x int8 and bf16 x packed int4 (the rungs with bf16 activations), f32,
and int8 x int8 and int8 x packed int4 (the int8-dynamic and int4-dynamic
rungs). Before it is timed, each call is held against its plain version
(``dp_gemm_region_plain``, ``streamk_phase1_plain`` on the contributor
slots, ``streamk_fixup_plain``, ``gemm_grouped_streamk_plain``,
``splitk_partials_plain``): 2e-2 x max|ref| for bf16 activations, 1e-4 for
f32 and int8 ones; a disagreement raises.
"""

import hashlib
import json
import math
import sys
import time


def report(path) -> int:
    """Per kernel and pair: each tree's device ms in run order, the ratio of
    the mean times (second tree over first), and whether every run of every
    tree gave the same output bytes."""
    runs = [json.loads(line) for line in open(path) if line.strip()]
    trees = list(dict.fromkeys(r["tree"] for r in runs))
    ms = {t: {} for t in trees}
    dig = {}
    for r in runs:
        for key, v in r["ms"].items():
            ms[r["tree"]].setdefault(key, []).append(v)
        for key, v in r["digests"].items():
            dig.setdefault(key, set()).add(v)
    print("| kernel, shape, pair | " + " | ".join(trees) + " | ratio | same bytes |")
    for key in ms[trees[0]]:
        cells = [" / ".join(f"{v:.5f}" for v in ms[t].get(key, [])) for t in trees]
        means = [sum(ms[t][key]) / len(ms[t][key]) for t in trees if ms[t].get(key)]
        ratio = f"{means[-1] / means[0]:.3f}" if len(means) == len(trees) else "-"
        same = {True: "yes", False: "NO"}[len(dig[key]) == 1] if key in dig else "-"
        print(f"| {key} | " + " | ".join(cells) + f" | {ratio} | {same} |")
    return 0


if __name__ == "__main__" and sys.argv[1:2] == ["--report"]:
    sys.exit(report(sys.argv[2]))
tree = sys.argv[1]
sys.path.insert(0, f"{tree}/src")

import torch  # noqa: E402

from repro_torch.core.policies import ALL_SK, DP, TileConfig  # noqa: E402
from repro_torch.core.quant import quantize_activations, quantize_weight  # noqa: E402
from repro_torch.core.workpart import GemmShape, partition  # noqa: E402
from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.kernels.dp.dp_gemm import dp_gemm_region, dp_gemm_region_plain  # noqa: E402
from repro_torch.kernels.splitk.splitk_gemm import (  # noqa: E402
    splitk_partials,
    splitk_partials_plain,
)
from repro_torch.kernels.streamk import ops as sk_ops  # noqa: E402
from repro_torch.kernels.streamk.grouped import (  # noqa: E402
    gemm_grouped_streamk,
    gemm_grouped_streamk_plain,
)
from repro_torch.kernels.streamk.streamk_gemm import (  # noqa: E402
    n_contributors,
    range_math,
    streamk_fixup,
    streamk_fixup_plain,
    streamk_phase1,
    streamk_phase1_plain,
)

try:
    from repro_torch.kernels.common import mainloop  # noqa: E402
except ImportError:  # a tree from before the mainloop was named per kernel
    mainloop = None


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


def rungs(a, b):
    """(pair, activations, weight, quantized kwargs, tolerance) of the six
    operand pairs, from bf16 ``a`` (..., M, K) and ``b`` (..., K, N)."""
    yield "bf16", a, b, {}, 2e-2
    for bits in (8, 4):
        q = quantize_weight(b, bits=bits)
        yield f"bf16*int{bits}", a, q.values, dict(scale=q.scales, b_bits=bits), 2e-2
    yield "f32", a.float(), b.float(), {}, 1e-4
    qa, scale_a = quantize_activations(a)
    for bits in (8, 4):
        q = quantize_weight(b, bits=bits)
        yield f"int8*int{bits}", qa, q.values, dict(scale=q.scales, scale_a=scale_a,
                                                    b_bits=bits), 1e-4


def copies(w, min_bytes=200 * 2**20):
    """``w`` and clones of it, together at least ``min_bytes``: the timed
    calls turn through them, so none is found in the L2."""
    n = max(1, math.ceil(min_bytes / (w.numel() * w.element_size())))
    return [w] + [w.clone() for _ in range(n - 1)]


def check(got, want, tol, what):
    err = (got.float() - want.float()).abs().max().item()
    if not err <= tol * max(1.0, want.float().abs().max().item()):
        raise AssertionError(f"{what}: max|err| {err:.3e}")


def digest(t):
    """The first 16 hex digits of the sha256 of ``t``'s bytes."""
    raw = t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()[:16]


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

    out, loops, digests = {}, {}, {}
    turn = iter(range(10**9))

    def key(name, shape, pair, a_dtype, kernel=None):
        """The JSON key of one timing; notes the mainloop ``kernel`` runs."""
        if kernel is not None and mainloop is not None:
            loops[f"{name} {pair}"] = mainloop(kernel, a_dtype)
        return f"{name} {shape}" + ("" if pair == "bf16" else f" {pair}")

    cfg1 = TileConfig(8, 128, 128)
    for pair, a, b, kw, tol in rungs(randn(4, 4096), randn(4096, 14336)):
        out_dt = torch.float32 if a.dtype == torch.float32 else torch.bfloat16
        c = torch.empty(4, 14336, dtype=out_dt, device="cuda")
        got = dp_gemm_region(a, b, cfg1, c=c, g=132, **kw)
        check(got, dp_gemm_region_plain(a, b, cfg1, torch.empty_like(c), **kw), tol, f"B1 {pair}")
        name = key("B1", "4x14336x4096", pair, a.dtype, "dp_gemm_region")
        digests[name] = digest(got)
        bs = copies(b)
        out[name] = time_ms(
            lambda: dp_gemm_region(a, bs[next(turn) % len(bs)], cfg1, c=c, g=132, **kw))
        del bs
    for pair, a, b, kw, tol in rungs(randn(4, 4096), randn(4096, 14336)):
        bits = kw.get("b_bits", 8)
        got = splitk_partials(a, b, cfg1, 4, b_bits=bits)
        check(got, splitk_partials_plain(a, b, cfg1, 4, b_bits=bits), tol, f"B6 {pair}")
        name = key("B6", "4x14336x4096 s4", pair, a.dtype, "splitk_partials")
        digests[name] = digest(got)
        bs = copies(b)
        out[name] = time_ms(lambda: splitk_partials(a, bs[next(turn) % len(bs)], cfg1, 4,
                                                    b_bits=bits))
        del bs, got
    cfg2 = TileConfig(8, 256, 128)
    part = partition(GemmShape(4, 4096, 14336), cfg2, 132, ALL_SK)
    used = (torch.arange(range_math(part)[3] + 1, device="cuda")[None, :]
            < n_contributors(part, "cuda")[:, None])
    for pair, a, b, kw, tol in rungs(randn(4, 14336), randn(14336, 4096)):
        out_dt = torch.float32 if a.dtype == torch.float32 else torch.bfloat16
        bits = kw.get("b_bits", 8)
        scales = {k_: v for k_, v in kw.items() if k_ != "b_bits"}
        partials = streamk_phase1(a, b, part, b_bits=bits)
        want = streamk_phase1_plain(a, b, part, b_bits=bits)
        check(partials[used], want[used], tol, f"B2 {pair}")
        c = torch.empty(4, 4096, dtype=out_dt, device="cuda")
        got = streamk_fixup(partials, part, c, **scales)
        check(got, streamk_fixup_plain(want, part, torch.empty_like(c), **scales), tol,
              f"B3 {pair}")
        name2 = key("B2", "4x4096x14336", pair, a.dtype, "streamk_phase1")
        name3 = key("B3", "4x4096x14336", pair, a.dtype)
        digests[name2], digests[name3] = digest(partials[used]), digest(got)
        bs = copies(b)
        out[name2] = time_ms(
            lambda: streamk_phase1(a, bs[next(turn) % len(bs)], part, b_bits=bits))
        out[name3] = time_ms(
            lambda: streamk_fixup(partials, part, c, **scales))
        out[key("B2+B3", "4x4096x14336", pair, a.dtype)] = time_ms(lambda: sk_ops.gemm(
            a, bs[next(turn) % len(bs)], policy=ALL_SK, cfg=cfg2, g=132, out_dtype=out_dt,
            **kw))
        del bs, partials, want
    for m, pol, cfg in ((4, DP, TileConfig(8, 256, 128)), (16, ALL_SK, TileConfig(16, 128, 128))):
        ga, gb = randn(64, m, 2048), randn(64, 2048, 1024)  # 268 MB of weights: past the L2
        for pair, a, b, kw, tol in rungs(ga, gb):
            out_dt = torch.float32 if a.dtype == torch.float32 else torch.bfloat16
            want = gemm_grouped_streamk_plain(a, b, sizes=(m,) * 64, out_dtype=out_dt,
                                              bk=cfg.bk, **kw)
            got = gemm_grouped_streamk(a, b, policy=pol, cfg=cfg, g=132, out_dtype=out_dt,
                                       **kw)
            check(got, want, tol, f"B5 {pair} {pol.name} m={m}")
            bs = copies(b)
            kernel = "grouped_streamk_dp" if pol is DP else "grouped_streamk_sk"
            name = key("B5", f"64x{m}x1024x2048 {pol.name}", pair, a.dtype, kernel)
            digests[name] = digest(got)
            out[name] = time_ms(
                lambda: gemm_grouped_streamk(a, bs[next(turn) % len(bs)], policy=pol, cfg=cfg,
                                             g=132, out_dtype=out_dt, **kw))
            del want, got, bs
    print(tree, "mainloop", json.dumps(loops), flush=True)
    print(tree, "digests", json.dumps(digests), flush=True)
    print(tree, json.dumps(out), flush=True)
    if "--out" in sys.argv:
        with open(sys.argv[sys.argv.index("--out") + 1], "a") as f:
            f.write(json.dumps(dict(tree=tree, ms=out, mainloop=loops, digests=digests)) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
