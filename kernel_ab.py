#!/usr/bin/env python3
"""Time the port's dense Hopper kernels of one checkout at decode shapes.

    python3 kernel_ab.py <tree> [--build-only | --served | --occupancy | --tuned] [--out FILE]
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
MB, four times the 50 MB L2), one of the mainloop each timed call runs per
operand pair (``repro_torch.kernels.common.mainloop``; null for a tree that
predates it) and one of a digest of the output bytes of each checked call
(sha256, first 16 hex digits); with ``--out`` it also appends all three as
one JSON record to FILE. ``--report FILE`` then prints, per kernel and
pair, each tree's times, the ratio of the mean times and whether every run
of every tree gave the same output bytes. Timed: B1 at 4x14336x4096 (DP
8x128x128), the Stream-K region B2+B3 at 4x4096x14336 (ALL_SK 8x256x128:
one launch on a tree that fuses the fix-up into the sweep, the sweep and
the fix-up in turn on an older one, under the same row names), and B5 at 64x4x1024x2048 (DP 8x256x128) and 64x16x1024x2048
(ALL_SK 16x128x128), all with g = 132, and B6 at 4x14336x4096 (split-K s =
4, 8x128x128, g = 0, one block per tile), each on eight operand pairs:
bf16, bf16 x int8 and bf16 x packed int4 (the rungs with bf16
activations), f32, f32 x int8 and f32 x packed int4 (f32 activations), and
int8 x int8 and int8 x packed int4 (the int8-dynamic and int4-dynamic
rungs); and olmoe-1b-7b's router, the one f32 GEMM a served path runs:
the composition at 4x64x2048, f32, under the H100 selector's pick (row
``B2+B3 router``; held against the same composition on the CPU, where
each kernel runs its plain version). Before it is timed, each call is held
against its plain version (``dp_gemm_region_plain``; for B2+B3
``streamk_phase1_plain`` on the contributor slots of split tiles and
``streamk_fixup_plain`` of it on C; ``gemm_grouped_streamk_plain``,
``splitk_partials_plain``): 2e-2 x max|ref| for bf16 activations, 1e-4
for f32 and int8 ones; a disagreement raises.

``--served`` times served decode steps instead: olmoe-1b-7b dense and on
the int8-dynamic rung, and granite-8b dense, each at full width from seed
0 with 4 slots, on the cuda backend and the card's default selector; after
three warm steps, ``SERVED_REPS`` steps are each traced by
``torch.profiler``, and each step's device ms in the GEMM kernels (names in
``GEMM_KERNELS``) is one sample. The report gives each tree's median,
least and most, and the ratio of the medians.

``--occupancy`` times the Stream-K region B2+B3 instead at the two grid
sizes the selector offers on the card beside g/2, g = 132 (one block an
SM) and g = 264 (two), on the instantiations of ``streamk_kernel`` whose
register count decides whether two blocks fit on an SM: dense f32 at M =
32 and 64 and int8 x packed int4 at M = 64, each at Mx4096x14336 (ALL_SK
Mx128x128), held against the plain composition first as above.

``--tuned`` compares, at each of granite-8b's decode projections (full
width, seed 0, 4 slots, one decode step's dispatches under the card's
default selector), the default selector's pick with the one a wall-clock
tune gives it (``measure_wallclock``, top-5 budget, the selector's
policies, tiles and grid sizes, served through a warm ``SelectorState``).
Each pick is timed alone as above, with the weights rotated past the L2
and with one copy left in it, beside the tuner's own reading (50 calls
issued back to back by the host, weights in L2); each row also gives its
dispatches a step and the sum over a step of each pick's time past the L2.
"""

import gc
import hashlib
import json
import math
import statistics
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
        for key, v in r.get("ms", {}).items():
            ms[r["tree"]].setdefault(key, []).append(v)
        for key, v in r.get("digests", {}).items():
            dig.setdefault(key, set()).add(v)
    served = {t: {} for t in trees}
    for r in runs:
        for key, v in r.get("served", {}).items():
            served[r["tree"]].setdefault(key, []).extend(v)
    if any(served.values()):
        print("| served GEMM ms a decode step | " + " | ".join(
            f"{t}: median (least-most, n)" for t in trees) + " | ratio of medians |")
        for key in served[trees[0]]:
            meds = [statistics.median(served[t][key]) for t in trees if served[t].get(key)]
            cells = [f"{statistics.median(v):.4f} ({min(v):.4f}-{max(v):.4f}, {len(v)})"
                     for v in (served[t].get(key, []) for t in trees) if v]
            ratio = f"{meds[-1] / meds[0]:.4f}" if len(meds) == len(trees) else "-"
            print(f"| {key} | " + " | ".join(cells) + f" | {ratio} |")
    if not any(ms.values()):
        return 0
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

from repro_torch.core.op import GemmOp  # noqa: E402
from repro_torch.core.policies import ALL_SK, DP, TileConfig  # noqa: E402
from repro_torch.core.quant import quantize_activations, quantize_weight  # noqa: E402
from repro_torch.core.selector import default_selector  # noqa: E402
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
    from repro_torch.kernels.streamk.streamk_gemm import streamk_region  # noqa: E402
except ImportError:  # a tree from before the fix-up was fused into the sweep
    streamk_region = None

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
    """(pair, activations, weight, quantized kwargs, tolerance) of the eight
    operand pairs, from bf16 ``a`` (..., M, K) and ``b`` (..., K, N)."""
    yield "bf16", a, b, {}, 2e-2
    for bits in (8, 4):
        q = quantize_weight(b, bits=bits)
        yield f"bf16*int{bits}", a, q.values, dict(scale=q.scales, b_bits=bits), 2e-2
    yield "f32", a.float(), b.float(), {}, 1e-4
    for bits in (8, 4):
        q = quantize_weight(b, bits=bits)
        yield f"f32*int{bits}", a.float(), q.values, dict(scale=q.scales, b_bits=bits), 1e-4
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


def sk_region(a, b, part, c, kw):
    """(C with its Stream-K tiles written, the contributor slots): one
    launch on a tree that fuses the fix-up into the sweep, the sweep and
    then the fix-up on an older one."""
    bits = kw.get("b_bits", 8)
    scales = {k_: v for k_, v in kw.items() if k_ != "b_bits"}
    if streamk_region is not None:
        return streamk_region(a, b, part, c, b_bits=bits, workspace=True, **scales)
    partials = streamk_phase1(a, b, part, b_bits=bits)
    return streamk_fixup(partials, part, c, **scales), partials


def digest(t):
    """The first 16 hex digits of the sha256 of ``t``'s bytes."""
    raw = t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()[:16]


#: the kernels a served step's GEMMs launch, by the names a trace gives them
#: (``fixup_kernel`` runs on a tree from before the fix-up was fused into
#: ``streamk_kernel``)
GEMM_KERNELS = ("dp_fma_kernel", "dp_mma_kernel", "dp_s8_kernel", "streamk_kernel",
                "fixup_kernel", "grouped_sk_kernel", "grouped_dp_kernel")
SERVED = (("olmoe-1b-7b", None), ("olmoe-1b-7b", "int8-dynamic"), ("granite-8b", None))
SERVED_REPS = 9


def served():
    """GEMM device ms of traced warm decode steps, per config of ``SERVED``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.gemm import gemm_context
    from repro_torch.models.lm import LM

    out = {}
    for arch, rung in SERVED:
        model = LM(get_config(arch))
        params = model.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))
        if rung == "int8-dynamic":
            params = model.quantize_weights(params, bits=8, act_bits=8)[0]
        cache = model.init_cache(4, 256, device="cuda")
        toks = torch.ones(4, 1, dtype=torch.long, device="cuda")
        cur = torch.zeros(4, dtype=torch.long, device="cuda")
        samples = []
        with gemm_context(selector=default_selector("cuda"), backend="cuda"):
            for _ in range(3):
                model.decode_step(params, cache, toks, cur)
            torch.cuda.synchronize()
            for _ in range(SERVED_REPS):
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    model.decode_step(params, cache, toks, cur)
                    torch.cuda.synchronize()
                samples.append(sum(e.time_range.elapsed_us() for e in prof.events()
                                   if e.device_type == DeviceType.CUDA
                                   and any(g in e.name for g in GEMM_KERNELS)) / 1e3)
        out[f"{arch} {rung or 'dense'}"] = samples
        print(tree, arch, rung or "dense", samples, flush=True)
        del model, params, cache
        gc.collect()
        torch.cuda.empty_cache()
    return out


def tuned():
    """Per ``--tuned``: granite-8b's decode projections, each under the
    default selector's pick and under a wall-clock tune's."""
    from collections import Counter

    from repro_torch.configs import get_config
    from repro_torch.core.gemm import gemm_context
    from repro_torch.core.selector import KernelSelector, SelectorState
    from repro_torch.core.tuner import Tuner, measure_wallclock
    from repro_torch.models.lm import LM

    model = LM(get_config("granite-8b"))
    params = model.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))
    cache = model.init_cache(4, 256, device="cuda")
    toks = torch.ones(4, 1, dtype=torch.long, device="cuda")
    cur = torch.zeros(4, dtype=torch.long, device="cuda")
    nominal = default_selector("cuda")
    with gemm_context(selector=nominal, backend="cuda") as ctx:
        model.decode_step(params, cache, toks, cur)
    del model, params, cache
    gc.collect()
    torch.cuda.empty_cache()
    per_step = Counter(e.op.key for e in ctx.log)
    entries, tags = {}, {}
    for e in ctx.log:
        if not e.op.fused:
            entries.setdefault(e.op.key, e)
            tags.setdefault(e.op.key, {})[e.tag] = None
    entries = list(entries.values())
    tuner = Tuner(policies=nominal.policies, tile_configs=nominal.tile_configs,
                  measure_fn=measure_wallclock(), mach=nominal.mach,
                  grid_sizes=nominal.grid_sizes, top_k=5)
    db = tuner.tune([e.op for e in entries])
    warm = KernelSelector(mach=nominal.mach, tile_configs=nominal.tile_configs,
                          state=SelectorState(db=db, sieve=db.build_sieve()))
    gen = torch.Generator(device="cuda").manual_seed(0)
    turn = iter(range(10**9))
    rows = []
    for e in entries:
        m, n, k = e.op.local
        a = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
        b = torch.randn(k, n, generator=gen, device="cuda").bfloat16()
        bs = copies(b)
        row = dict(tag="/".join(tags[e.op.key]), shape=[m, n, k],
                   per_step=per_step[e.op.key],
                   tuner_ms=2 * m * n * k / (db.records[e.op.key].tflops * 1e12) * 1e3)
        for name, sel in (("nominal", e.selection), ("tuned", warm.select_op(e.op))):
            if name == "tuned" and sel.source != "tuned":
                raise AssertionError(f"{e.tag}: the warm selector's source is {sel.source}")
            kw = dict(policy=sel.policy, cfg=sel.cfg, g=sel.g)
            check(sk_ops.gemm(a, b, **kw), a.float() @ b.float(), 2e-2, f"{e.tag} {name}")
            row[f"{name}_pick"] = f"{sel.policy.name}/{sel.cfg.name}/g{sel.g}"
            row[f"{name}_ms"] = time_ms(
                lambda kw=kw: sk_ops.gemm(a, bs[next(turn) % len(bs)], **kw))
            row[f"{name}_l2_ms"] = time_ms(lambda kw=kw: sk_ops.gemm(a, b, **kw))
        rows.append(row)
        print(tree, json.dumps(row), flush=True)
        del bs
    step = {name: sum(r["per_step"] * r[f"{name}_ms"] for r in rows)
            for name in ("nominal", "tuned")}
    print(tree, "a step's decode projections alone, ms past the L2", json.dumps(step),
          flush=True)
    return dict(rows=rows, step_ms=step)


def occupancy(randn, turn):
    """(ms, digests) of B2+B3 at g = 132 and 264, per ``--occupancy``."""
    out, digests = {}, {}
    for m, pairs in ((32, ("f32",)), (64, ("f32", "int8*int4"))):
        cfg = TileConfig(m, 128, 128)
        for pair, a, b, kw, tol in rungs(randn(m, 14336), randn(14336, 4096)):
            if pair not in pairs:
                continue
            for g in (132, 264):
                part = partition(GemmShape(m, 4096, 14336), cfg, g, ALL_SK)
                out_dt = torch.float32 if a.dtype == torch.float32 else torch.bfloat16
                scales = {k_: v for k_, v in kw.items() if k_ != "b_bits"}
                c = torch.empty(m, 4096, dtype=out_dt, device="cuda")
                got = sk_region(a, b, part, c, kw)[0]
                want = streamk_phase1_plain(a, b, part, b_bits=kw.get("b_bits", 8))
                check(got, streamk_fixup_plain(want, part, torch.empty_like(c), **scales), tol,
                      f"B2+B3 {pair} m={m} g={g}")
                name = f"B2+B3 occupancy {m}x4096x14336 g{g} {pair}"
                digests[name] = digest(got)
                bs = copies(b)
                out[name] = time_ms(lambda: sk_ops.gemm(
                    a, bs[next(turn) % len(bs)], policy=ALL_SK, cfg=cfg, g=g,
                    out_dtype=out_dt, **kw))
                del bs, want, got
    return out, digests


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    cuda_lib.library()
    print(tree, "build", round(time.perf_counter() - t0, 1), flush=True)
    if "--build-only" in sys.argv:
        return 0
    if "--served" in sys.argv:
        rec = dict(tree=tree, served=served())
        if "--out" in sys.argv:
            with open(sys.argv[sys.argv.index("--out") + 1], "a") as f:
                f.write(json.dumps(rec) + "\n")
        return 0
    if "--tuned" in sys.argv:
        rec = dict(tree=tree, tuned=tuned())
        if "--out" in sys.argv:
            with open(sys.argv[sys.argv.index("--out") + 1], "a") as f:
                f.write(json.dumps(rec) + "\n")
        return 0
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    out, loops, digests = {}, {}, {}
    turn = iter(range(10**9))
    if "--occupancy" in sys.argv:
        out, digests = occupancy(randn, turn)
        print(tree, json.dumps(out), flush=True)
        if "--out" in sys.argv:
            with open(sys.argv[sys.argv.index("--out") + 1], "a") as f:
                f.write(json.dumps(dict(tree=tree, ms=out, digests=digests)) + "\n")
        return 0

    def key(name, shape, pair, a_dtype, kernel=None):
        """The JSON key of one timing; notes the mainloop ``kernel`` runs."""
        k_ = f"{name} {shape}" + ("" if pair == "bf16" else f" {pair}")
        if kernel is not None and mainloop is not None:
            loops[k_] = mainloop(kernel, a_dtype)
        return k_

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
    nc = n_contributors(part, "cuda")
    # the slots the card defines on every pair: those of split tiles, below their count
    split = (torch.arange(range_math(part)[3] + 1, device="cuda")[None, :] < nc[:, None]) & (
        nc > 1)[:, None]
    for pair, a, b, kw, tol in rungs(randn(4, 14336), randn(14336, 4096)):
        out_dt = torch.float32 if a.dtype == torch.float32 else torch.bfloat16
        bits = kw.get("b_bits", 8)
        scales = {k_: v for k_, v in kw.items() if k_ != "b_bits"}
        c = torch.empty(4, 4096, dtype=out_dt, device="cuda")
        got, partials = sk_region(a, b, part, c, kw)
        want = streamk_phase1_plain(a, b, part, b_bits=bits)
        check(partials[split], want[split], tol, f"B2 {pair}")
        check(got, streamk_fixup_plain(want, part, torch.empty_like(c), **scales), tol,
              f"B2+B3 {pair}")
        name = key("B2+B3", "4x4096x14336", pair, a.dtype, "streamk_phase1")
        digests[name] = digest(got)
        bs = copies(b)
        out[name] = time_ms(lambda: sk_ops.gemm(
            a, bs[next(turn) % len(bs)], policy=ALL_SK, cfg=cfg2, g=132, out_dtype=out_dt,
            **kw))
        del bs, partials, want
    pick = default_selector("cuda").select_op(
        GemmOp.plain(4, 64, 2048, in_dtype="float32", out_dtype="float32"))
    a, b = randn(4, 2048).float(), randn(2048, 64).float()
    router = dict(policy=pick.policy, cfg=pick.cfg, g=pick.g, out_dtype=torch.float32)
    got = sk_ops.gemm(a, b, **router)
    check(got, sk_ops.gemm(a.cpu(), b.cpu(), **router).cuda(), 1e-4, "B2+B3 router")
    name = key("B2+B3 router", "4x64x2048", "f32", a.dtype, "streamk_phase1")
    print(tree, "router pick", pick.policy.name, pick.cfg.name, pick.g, flush=True)
    digests[name] = digest(got)
    bs = copies(b)
    out[name] = time_ms(lambda: sk_ops.gemm(a, bs[next(turn) % len(bs)], **router))
    del bs
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
