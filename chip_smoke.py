#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Device: a CUDA card of capability (9, 0); prints the card's name and
   power limit, builds the hand-written kernels from ``src/repro_torch/csrc``
   (one nvcc per source, all at once) and prints the build time and the
   ptxas register/spill report.
2. Kernels against their plain PyTorch versions, on the card:
   * B1-B3, the full sweep at M=64, N=4096, K=4096 (and two small ragged
     shapes, one per staging path): all 8 policies x 2 grid sizes x {bf16
     (2e-2), f32 (1e-4)} x epilogues {none, mul_silu, bias+gelu}; B2's
     partials against the plain phase 1 (the contributor slots), B3's and
     B1's C against their plain versions, the composed C against the
     f32-accumulated ``gemm_ref``;
   * the plain projection shapes of granite-8b and olmoe-1b-7b (attention,
     MLP, router in f32, lm_head), M in {1, 4, 64} and each served prompt
     length, under the H100 selector's pick, DP and ALL_SK, against
     ``gemm_ref``; B2+B3 bitwise identical across two runs;
   * B5, the grouped kernel, at olmoe-1b-7b's expert shapes (64 experts x
     4 or 16 rows, 2048 -> 1024 and 1024 -> 2048) and a small unaligned one:
     every policy x g in {66, 132, 264} x {bf16, f32} x epilogues {none,
     gelu, bias, mul_silu} x group sizes {full, ragged with empty groups}
     against its plain version and per-group ``gemm_ref``; all-empty sizes
     launch nothing; the Stream-K form with split tiles is bitwise
     deterministic;
   * each kernel timed with CUDA events at a decode shape it serves (device
     time of calls queued to run back to back, and the time of calls as the
     host issues them; see ``time_ms``), beside its plain version, one
     library call computing the same function (``torch.matmul`` for B1, and
     for B2/B3 the whole GEMM they compose; ``torch.bmm`` for B5) and its
     bound (bytes over 3.35 TB/s or operations over 989 TFLOP/s, whichever
     is larger).
3. Serve, through ``ServeEngine`` on the ``cuda`` backend, 4 slots, max_seq
   256, 4 seeded requests of 16-64 tokens, 8 new tokens each, with seeded
   random weights: granite-8b at full width (36 layers, d_model 4096, bf16,
   ~16.5 GB), then, its weights freed, olmoe-1b-7b at full width (16 layers,
   d_model 2048, 64 experts top-8, bf16, ~13.8 GB). For each, the launch
   counters are zeroed just before the run and read just after; every
   kernel the selections call for must have launched, and each fused
   grouped dispatch must be exactly one B5 launch (48 per olmoe decode
   step). The first request's prefill logits are held against the ``torch``
   backend on the same weights (for olmoe the routing choices the two
   backends made differently are counted), and so are the logits of a
   planted fault, which must fail that limit: granite's DP GEMMs, or
   olmoe's grouped GEMMs, with their last K chunk dropped. A warm decode
   step is then broken down (wall time, host enqueue time, device busy time
   from ``torch.profiler``) under the ``cuda`` backend and, as the
   yardstick, the ``torch`` backend.

Tolerances: a kernel output ``x`` agrees with its reference ``r`` when
``max|x - r| <= tol * max(1, max|r|)``: 1e-4 for f32 inputs (f32 sums in
another order), 2e-2 for bf16 (one bf16 rounding of the output). The served
logits agree within ``LOGITS_TOL`` x max|logit|: 3e-2 for granite-8b's 36
layers of bf16 activations rounded at different points of two summation
orders (a sound run reads about 1.7e-2 on the seeded weights), and 5e-2 for
olmoe-1b-7b, whose sound run reads 2.3e-2: there the same roundings also
flip near-tied top-8 routing choices (the run counts them), and its planted
fault reads 0.18, 3.7 times the limit.

The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BF16 = 989e12  # FLOP/s, H100 SXM dense tensor-core peak (data sheet)
PEAK_F32 = 67e12  # FLOP/s, H100 SXM f32 outside the tensor cores
HBM_BW = 3.35e12  # B/s, H100 SXM HBM3 (data sheet)
SLICE_NK = [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336), (49152, 4096)]
GRANITE_NK = [(n, k, "bfloat16") for n, k in SLICE_NK]
#: olmoe-1b-7b's plain projections (N, K, dtype): attention, lm_head, router
OLMOE_NK = [(2048, 2048, "bfloat16"), (50304, 2048, "bfloat16"), (64, 2048, "float32")]
#: olmoe-1b-7b's expert GEMMs (G, M, N, K): moe.gate/in (2048 -> 1024) and
#: moe.out (1024 -> 2048) at decode capacity (M = 4 with 4 slots) and prompt
#: capacity (M = 16 for 16-64 tokens)
GROUPED_SHAPES = ((64, 4, 1024, 2048), (64, 4, 2048, 1024), (64, 16, 1024, 2048),
                  (64, 16, 2048, 1024))
#: a small grouped shape whose rows are not 16-byte aligned (element-wise staging)
GROUPED_RAGGED = (5, 20, 302, 200)
REPLACES = {
    "dp_gemm_region": "src/repro/kernels/dp/dp_gemm.py:40",
    "streamk_phase1": "src/repro/kernels/streamk/streamk_gemm.py:78",
    "streamk_fixup": "src/repro/kernels/streamk/streamk_gemm.py:179",
    "grouped_streamk_sk": "src/repro/kernels/streamk/grouped.py:93",
    "grouped_streamk_dp": "src/repro/kernels/streamk/grouped.py:156",
}
SOURCE = "src/repro_torch/csrc/stream_k.cu"
GROUPED_SOURCE = "src/repro_torch/csrc/grouped.cuh"  # instantiated by grouped.cu, grouped_bf16.cu
SOURCES = dict.fromkeys(("dp_gemm_region", "streamk_phase1", "streamk_fixup"), SOURCE)
SOURCES.update(dict.fromkeys(("grouped_streamk_sk", "grouped_streamk_dp"), GROUPED_SOURCE))
#: served prefill logits vs the torch backend, x max|logit|, per model: a
#: sound granite-8b run reads 1.7e-2 and its planted fault 0.39; a sound
#: olmoe-1b-7b run reads 2.3e-2 (bf16 roundings that differ flip about a
#: fifth of its near-tied top-8 choices) and its planted fault 0.18
LOGITS_TOL = {"granite-8b": 3e-2, "olmoe-1b-7b": 5e-2}
N_SLOTS, MAX_SEQ = 4, 256


def serve_prompts(vocab_size):
    """The served run's 4 seeded prompts of 16-64 tokens."""
    rng = np.random.default_rng(0)
    return [rng.integers(1, vocab_size, size=int(rng.integers(16, 65))) for _ in range(4)]


def log(*args):
    print(*args, flush=True)


def close(got, want, tol, what):
    """max|got - want| after checking it is within tol * max(1, max|want|)."""
    import torch

    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite output")
    err = (got - want).abs().max().item()
    scale = max(1.0, want.abs().max().item())
    if err > tol * scale:
        raise AssertionError(f"{what}: max|err| {err:.3e} > {tol} * {scale:.3e}")
    return err


def device_ms_by_name(prof):
    """Milliseconds of device activity (kernels, copies) in a profiler
    trace, summed by name."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return by_name


def time_ms(fn, iters=20, warmup=3):
    """(device ms, event ms) per call over ``iters`` calls, by CUDA events.

    Event ms: events around ``iters`` calls as the host issues them, so it
    also counts the gaps while the host prepares the next launch. Device
    ms: the same calls queued behind a spin kernel that keeps the card busy
    for about twice the host's time to issue them, so the events see the
    calls run back to back — the kernels' own time. The two differ where the
    host cannot keep the card fed."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    issue_s = time.perf_counter() - t0
    event_ms = start.elapsed_time(end) / iters
    torch.cuda._sleep(int(2 * issue_s * 2e9))  # cycles: about 2 x issue_s at <= 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, event_ms


# ---------------------------------------------------------------------------
# Phase 1: device and build
# ---------------------------------------------------------------------------


def phase_device():
    import torch

    from repro_torch.kernels import cuda_lib

    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"needs a Hopper card (capability (9, 0)), found {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(smi)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    cuda_lib.library()
    build_s = time.perf_counter() - t0
    log(f"kernels built from src/repro_torch/csrc/*.cu in {build_s:.1f}s -> "
        f"{cuda_lib.build_info['path']}")
    for line in cuda_lib.build_info["ptxas"].splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())
    return smi, build_s


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _operands(m, n, k, dtype, gen):
    import torch

    a = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    b = (torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)).to(dtype)
    bias = torch.randn(n, generator=gen, device="cuda").to(dtype)
    operand = torch.randn(m, n, generator=gen, device="cuda").to(dtype)
    return a, b, bias, operand


def _used_slots(partials, part):
    import torch

    from repro_torch.kernels.streamk.streamk_gemm import n_contributors

    nc = n_contributors(part, partials.device)
    return (torch.arange(partials.shape[1], device=partials.device)[None, :] < nc[:, None])[
        :, :, None, None
    ]


#: the full sweep's shapes: the main one, a ragged one whose rows stay
#: 16-byte aligned (the cp.async path with zero-filled edges), and one whose
#: rows do not (the element-wise staging path)
SWEEP_SHAPES = ((64, 4096, 4096), (20, 392, 520), (17, 302, 200))


def sweep(gen):
    """All policies x 2 g x 2 dtypes x 3 epilogues at each sweep shape."""
    import torch

    from repro_torch.core.op import Epilogue
    from repro_torch.core.policies import ALL_POLICIES
    from repro_torch.core.selector import default_selector
    from repro_torch.core.workpart import GemmShape, partition
    from repro_torch.kernels.dp.dp_gemm import dp_gemm_region, dp_gemm_region_plain
    from repro_torch.kernels.streamk import ops
    from repro_torch.kernels.streamk.ref import gemm_ref
    from repro_torch.kernels.streamk.streamk_gemm import (
        streamk_fixup, streamk_fixup_plain, streamk_phase1, streamk_phase1_plain,
    )
    from repro_torch.core.op import GemmOp
    from repro_torch.core.gemm import dtype_name

    errs = {"dp_gemm_region": 0.0, "streamk_phase1": 0.0, "streamk_fixup": 0.0, "gemm": 0.0}
    sel = default_selector("cuda")
    cases = 0
    for (m, n, k), dtype, tol in (
        (shape, dt, tol) for shape in SWEEP_SHAPES
        for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4))
    ):
        a, b, bias, operand = _operands(m, n, k, dtype, gen)
        cfg = sel.select_op(GemmOp.plain(m, n, k, in_dtype=dtype_name(dtype))).cfg
        ref_acc = gemm_ref(a, b, torch.float32)
        for epi_name, epi, kw in (
            ("none", Epilogue(), {}),
            ("mul_silu", Epilogue(binary="mul_silu"), {"operand": operand}),
            ("bias+gelu", Epilogue(activation="gelu", bias=True), {"bias": bias}),
        ):
            want = epi.apply(ref_acc, **{key: v for key, v in kw.items()}).to(dtype)
            for pol in ALL_POLICIES:
                for g in (66, 132):
                    what = (f"{m}x{n}x{k} {dtype_name(dtype)} {pol.name} g={g} {cfg.name} "
                            f"{epi_name}")
                    part = partition(GemmShape(m, n, k), cfg, g, pol)
                    c = ops.gemm(a, b, policy=pol, cfg=cfg, g=g, epilogue=epi, **kw)
                    errs["gemm"] = max(errs["gemm"], close(c, want, tol, what))
                    c_k = torch.zeros(m, n, dtype=dtype, device="cuda")
                    c_p = torch.zeros(m, n, dtype=dtype, device="cuda")
                    if part.sk_tiles:
                        p_k = streamk_phase1(a, b, part)
                        p_p = streamk_phase1_plain(a, b, part)
                        used = _used_slots(p_k, part)
                        errs["streamk_phase1"] = max(errs["streamk_phase1"], close(
                            torch.where(used, p_k, 0.0), torch.where(used, p_p, 0.0), tol,
                            what + " B2"))
                        streamk_fixup(p_k, part, c_k, epilogue=epi, **kw)
                        streamk_fixup_plain(p_k, part, c_p, epilogue=epi, **kw)
                        errs["streamk_fixup"] = max(errs["streamk_fixup"],
                                                    close(c_k, c_p, tol, what + " B3"))
                    if part.dp_tiles:
                        dp_gemm_region(a, b, cfg, c=c_k, tile_offset=part.sk_tiles, g=g,
                                       epilogue=epi, **kw)
                        dp_gemm_region_plain(a, b, cfg, c_p, tile_offset=part.sk_tiles,
                                             epilogue=epi, **kw)
                        errs["dp_gemm_region"] = max(errs["dp_gemm_region"],
                                                     close(c_k, c_p, tol, what + " B1"))
                    cases += 1
    torch.cuda.synchronize()
    return errs, cases


def slice_ms(arch):
    """The M of every plain GEMM the served run issues: lm_head's single row,
    the decode batch, the sweep's 64 and each prompt's prefill length (ragged
    edges inside a 64-row sub-block)."""
    from repro_torch.configs import get_config

    lens = {len(p) for p in serve_prompts(get_config(arch).vocab_size)}
    return sorted({1, N_SLOTS, 64} | lens)


def slice_shapes(gen, arch, nk_dtypes):
    """A model's plain projection shapes under the H100 pick, DP and ALL_SK."""
    import torch

    from repro_torch.core.gemm import as_dtype, dtype_name
    from repro_torch.core.op import GemmOp
    from repro_torch.core.policies import ALL_SK, DP
    from repro_torch.core.selector import default_selector
    from repro_torch.core.workpart import GemmShape, partition
    from repro_torch.kernels.streamk import ops
    from repro_torch.kernels.streamk.ref import gemm_ref
    from repro_torch.kernels.streamk.streamk_gemm import streamk_fixup, streamk_phase1

    sel = default_selector("cuda")
    worst = 0.0
    picks = []
    for m in slice_ms(arch):
        for n, k, dt in nk_dtypes:
            a, b, _, _ = _operands(m, n, k, as_dtype(dt), gen)
            tol = 2e-2 if a.dtype == torch.bfloat16 else 1e-4
            s = sel.select_op(GemmOp.plain(m, n, k, in_dtype=dtype_name(a.dtype)))
            picks.append({"arch": arch, "m": m, "n": n, "k": k, "dtype": dt,
                          "policy": s.policy.name, "tile": s.cfg.name, "g": s.g})
            want = gemm_ref(a, b, torch.float32)
            for pol, cfg, g in ((s.policy, s.cfg, s.g), (DP, s.cfg, s.g), (ALL_SK, s.cfg, s.g)):
                c = ops.gemm(a, b, policy=pol, cfg=cfg, g=g)
                worst = max(worst, close(c, want, tol, f"{m}x{n}x{k} {dt} {pol.name} {cfg.name}"))
            # determinism: the sweep and the ordered fix-up are bit-identical
            part = partition(GemmShape(m, n, k), s.cfg, s.g, ALL_SK)
            c1 = torch.empty(m, n, dtype=a.dtype, device="cuda")
            c2 = torch.empty(m, n, dtype=a.dtype, device="cuda")
            streamk_fixup(streamk_phase1(a, b, part), part, c1)
            streamk_fixup(streamk_phase1(a, b, part), part, c2)
            if not torch.equal(c1, c2):
                raise AssertionError(f"{m}x{n}x{k}: B2+B3 not bitwise deterministic")
    torch.cuda.synchronize()
    return worst, picks


def _rotating(b, min_bytes=200 * 2**20):
    """Copies of a weight whose total exceeds the 50 MB L2, so timed calls
    read it from device memory as a decode step does."""
    copies = max(1, math.ceil(min_bytes / (b.numel() * b.element_size())))
    return [b.clone() for _ in range(copies)]


def _sk_region_bytes_ops(part, m, n, k, in_bytes):
    """What the SK region's real data (rows < M, columns < N) needs:
    (B2 bytes, B2 operations, partial bytes, C elements, B3 additions).
    B2 reads each A row and B column of the region once, writes each
    contributor's partial of each real element once and does 2 operations
    per real multiply-add; B3 reads those partials back, adds each
    element's contributors and writes C."""
    cfg = part.cfg
    rows, cols, elems, slot_bytes, adds = set(), set(), 0, 0, 0
    for c in part.contributions:
        tm, tn = part.tile_mn(c.tile)
        r = max(0, min(m, (tm + 1) * cfg.bm) - tm * cfg.bm)
        q = max(0, min(n, (tn + 1) * cfg.bn) - tn * cfg.bn)
        rows.add(tm)
        cols.add(tn)
        elems += r * q
        slot_bytes += c.num_contributors * r * q * 4
        adds += (c.num_contributors - 1) * r * q
    a_rows = sum(max(0, min(m, (t + 1) * cfg.bm) - t * cfg.bm) for t in rows)
    b_cols = sum(max(0, min(n, (t + 1) * cfg.bn) - t * cfg.bn) for t in cols)
    read = (a_rows + b_cols) * k * in_bytes
    return read + slot_bytes, 2 * elems * k, slot_bytes, elems, adds


def bound_ms(nbytes, ops, peak=PEAK_BF16):
    t_bytes, t_ops = nbytes / HBM_BW, ops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_kernels(gen):
    """Each kernel at a decode shape (M = 4 slots) where the H100 selector
    uses it: B1 at mlp.gate (4, 14336, 4096, DP), B2/B3 at mlp.out
    (4, 4096, 14336, ALL_SK); then each again, beside its plain version, at
    the sweep shape (64, 4096, 4096)."""
    import torch

    from repro_torch.core.gemm import dtype_name
    from repro_torch.core.op import GemmOp
    from repro_torch.core.policies import ALL_SK
    from repro_torch.core.selector import default_selector
    from repro_torch.core.workpart import GemmShape, partition
    from repro_torch.kernels.dp.dp_gemm import dp_gemm_region, dp_gemm_region_plain
    from repro_torch.kernels.streamk import ops as sk_ops
    from repro_torch.kernels.streamk.streamk_gemm import (
        streamk_fixup, streamk_fixup_plain, streamk_phase1, streamk_phase1_plain,
    )

    sel = default_selector("cuda")
    out = {}

    # B1 ------------------------------------------------------------------
    m, n, k = 4, 14336, 4096
    a, b, _, _ = _operands(m, n, k, torch.bfloat16, gen)
    s = sel.select_op(GemmOp.plain(m, n, k, in_dtype=dtype_name(a.dtype)))
    if s.policy.is_streamk:
        raise AssertionError(f"expected a DP pick at {m}x{n}x{k}, got {s.policy.name}")
    c = torch.empty(m, n, dtype=a.dtype, device="cuda")
    c_p = torch.empty_like(c)
    err = close(dp_gemm_region(a, b, s.cfg, c=c, g=s.g),
                dp_gemm_region_plain(a, b, s.cfg, c_p), 2e-2, "B1 timing shape")
    bs = _rotating(b)
    it = iter(range(10**9))
    ms, ev = time_ms(lambda: dp_gemm_region(a, bs[next(it) % len(bs)], s.cfg, c=c, g=s.g))
    plain, plain_ev = time_ms(lambda: dp_gemm_region_plain(a, bs[next(it) % len(bs)], s.cfg, c_p))
    lib, lib_ev = time_ms(lambda: torch.matmul(a, bs[next(it) % len(bs)]))
    bnd, by = bound_ms((m * k + k * n + m * n) * 2, 2 * m * n * k)
    out["dp_gemm_region"] = dict(shape=[m, n, k], policy=s.policy.name, tile=s.cfg.name, g=s.g,
                                 max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                                 bound_by=by, library_ms=lib, event_ms=ev,
                                 plain_event_ms=plain_ev, library_event_ms=lib_ev)

    # B2 and B3 ----------------------------------------------------------------
    m, n, k = 4, 4096, 14336
    a, b, _, _ = _operands(m, n, k, torch.bfloat16, gen)
    s = sel.select_op(GemmOp.plain(m, n, k, in_dtype=dtype_name(a.dtype)))
    part = partition(GemmShape(m, n, k), s.cfg, s.g, s.policy)
    if not part.sk_tiles:
        raise AssertionError(f"expected a Stream-K pick at {m}x{n}x{k}, got {s.policy.name}")
    p_k = streamk_phase1(a, b, part)
    used = _used_slots(p_k, part)
    err2 = close(torch.where(used, p_k, 0.0),
                 torch.where(used, streamk_phase1_plain(a, b, part), 0.0), 2e-2, "B2 timing")
    bs = _rotating(b)
    ms2, ev2 = time_ms(lambda: streamk_phase1(a, bs[next(it) % len(bs)], part))
    # one call: the plain sweep issues hundreds of small launches per call
    plain2, plain_ev2 = time_ms(lambda: streamk_phase1_plain(a, bs[next(it) % len(bs)], part),
                                iters=1)
    nbytes, ops, slot_bytes, elems, adds = _sk_region_bytes_ops(part, m, n, k, 2)
    bnd2, by2 = bound_ms(nbytes, ops)
    # no single library call computes B2's partials or B3's reduction: their
    # yardstick is torch.matmul of the whole GEMM they compose, beside the
    # composition's own time
    lib23, lib23_ev = time_ms(lambda: torch.matmul(a, bs[next(it) % len(bs)]))
    composed, composed_ev = time_ms(
        lambda: sk_ops.gemm(a, bs[next(it) % len(bs)], policy=ALL_SK, cfg=s.cfg, g=s.g))
    composition = dict(library_of="torch.matmul of the whole GEMM (B2 + B3 compose it)",
                       composed_ms=composed, composed_event_ms=composed_ev,
                       library_event_ms=lib23_ev)
    out["streamk_phase1"] = dict(shape=[m, n, k], policy=s.policy.name, tile=s.cfg.name, g=s.g,
                                 max_abs_err=err2, ms=ms2, plain_ms=plain2, bound_ms=bnd2,
                                 bound_by=by2, library_ms=lib23, event_ms=ev2,
                                 plain_event_ms=plain_ev2, **composition)
    c = torch.empty(m, n, dtype=a.dtype, device="cuda")
    c_p = torch.empty_like(c)
    err3 = close(streamk_fixup(p_k, part, c), streamk_fixup_plain(p_k, part, c_p), 2e-2,
                 "B3 timing")
    ms3, ev3 = time_ms(lambda: streamk_fixup(p_k, part, c))
    plain3, plain_ev3 = time_ms(lambda: streamk_fixup_plain(p_k, part, c_p))
    bnd3, by3 = bound_ms(slot_bytes + elems * 2, adds, PEAK_F32)
    out["streamk_fixup"] = dict(shape=[m, n, k], policy=s.policy.name, tile=s.cfg.name, g=s.g,
                                max_abs_err=err3, ms=ms3, plain_ms=plain3, bound_ms=bnd3,
                                bound_by=by3, library_ms=lib23, event_ms=ev3,
                                plain_event_ms=plain_ev3, **composition)

    # each kernel beside its plain version at the sweep shape (device ms)
    m, n, k = SWEEP_SHAPES[0]
    a, b, _, _ = _operands(m, n, k, torch.bfloat16, gen)
    bs = _rotating(b)
    cfg = sel.select_op(GemmOp.plain(m, n, k, in_dtype=dtype_name(a.dtype))).cfg
    part = partition(GemmShape(m, n, k), cfg, 132, ALL_SK)
    p_k = streamk_phase1(a, b, part)
    c = torch.empty(m, n, dtype=a.dtype, device="cuda")
    c_p = torch.empty_like(c)
    pairs = {
        "dp_gemm_region": (lambda: dp_gemm_region(a, bs[next(it) % len(bs)], cfg, c=c, g=132),
                           lambda: dp_gemm_region_plain(a, bs[next(it) % len(bs)], cfg, c_p)),
        "streamk_phase1": (lambda: streamk_phase1(a, bs[next(it) % len(bs)], part),
                           lambda: streamk_phase1_plain(a, bs[next(it) % len(bs)], part)),
        "streamk_fixup": (lambda: streamk_fixup(p_k, part, c),
                          lambda: streamk_fixup_plain(p_k, part, c_p)),
    }
    for name, (kernel, plain) in pairs.items():
        out[name].update(sweep_shape=[m, n, k, cfg.name], sweep_ms=time_ms(kernel)[0],
                         sweep_plain_ms=time_ms(plain, iters=1)[0])
    return out


def time_main_path_gemms(gen, m):
    """The whole composition (every kernel the pick launches) at each slice
    shape, beside torch.matmul and the bound of the full GEMM."""
    import torch

    from repro_torch.core.gemm import dtype_name
    from repro_torch.core.op import GemmOp
    from repro_torch.core.selector import default_selector
    from repro_torch.kernels.streamk import ops

    sel = default_selector("cuda")
    rows = []
    for n, k in SLICE_NK:
        a, b, _, _ = _operands(m, n, k, torch.bfloat16, gen)
        s = sel.select_op(GemmOp.plain(m, n, k, in_dtype=dtype_name(a.dtype)))
        bs = _rotating(b)
        it = iter(range(10**9))
        ms, ev = time_ms(lambda: ops.gemm(a, bs[next(it) % len(bs)], policy=s.policy,
                                          cfg=s.cfg, g=s.g))
        lib, lib_ev = time_ms(lambda: torch.matmul(a, bs[next(it) % len(bs)]))
        bnd, by = bound_ms((m * k + k * n + m * n) * 2, 2 * m * n * k)
        rows.append(dict(shape=[m, n, k], policy=s.policy.name, tile=s.cfg.name, g=s.g, ms=ms,
                         event_ms=ev, library_ms=lib, library_event_ms=lib_ev, bound_ms=bnd,
                         bound_by=by))
        log(f"  gemm {m}x{n}x{k} {s.policy.name}/{s.cfg.name} g={s.g}: device {ms:.4f} ms, "
            f"events {ev:.4f} ms (torch.matmul {lib:.4f} / {lib_ev:.4f} ms, bound {bnd:.4f} ms "
            f"by {by})")
    return rows


# ---------------------------------------------------------------------------
# Phase 2b: B5, the grouped kernel, against its plain version
# ---------------------------------------------------------------------------


def _grouped_operands(g, m, n, k, dtype, gen):
    import torch

    a = torch.randn(g, m, k, generator=gen, device="cuda").to(dtype)
    b = (torch.randn(g, k, n, generator=gen, device="cuda") / math.sqrt(k)).to(dtype)
    bias = torch.randn(g, n, generator=gen, device="cuda").to(dtype)
    operand = torch.randn(g, m, n, generator=gen, device="cuda").to(dtype)
    return a, b, bias, operand


def grouped_pick(g, m, n, k, dtype):
    """The H100 selector's pick for a fused grouped op (no epilogue)."""
    from repro_torch.core.gemm import dtype_name
    from repro_torch.core.op import GemmOp
    from repro_torch.core.selector import default_selector

    dt = dtype_name(dtype)
    return default_selector("cuda").select_op(
        GemmOp(m, n, k, g=g, kind="grouped", in_dtype=dt, out_dtype=dt, fused=True))


def _grouped_kernel_name(policy):
    from repro_torch.core.policies import PolicyKind

    return "grouped_streamk_dp" if policy.kind == PolicyKind.DP else "grouped_streamk_sk"


def _splits_tiles(sizes, n, k, cfg, g):
    """True when some Stream-K workgroup boundary falls inside a tile."""
    from repro_torch.core.workpart import cdiv

    ipt = cdiv(k, cfg.bk)
    total = sum(cdiv(s, cfg.bm) for s in sizes) * cdiv(n, cfg.bn) * ipt
    ipw = cdiv(total, g)
    return total > ipw and ipw % ipt != 0


def sweep_grouped(gen):
    """B5 at olmoe-1b-7b's expert shapes and a small unaligned one: every
    policy (DP; ALL_SK and the HYBRIDs, which run the Stream-K form) x g in
    {66, 132, 264} x {bf16 (2e-2), f32 (1e-4)} x epilogues {none, gelu,
    bias, mul_silu} x group sizes {full, ragged with empty groups}, against
    the plain version and per-group ``gemm_ref``; all-empty sizes launch
    nothing; the Stream-K form with split tiles is bit-identical across two
    runs."""
    import torch

    from repro_torch.core.op import Epilogue
    from repro_torch.core.policies import ALL_POLICIES, ALL_SK
    from repro_torch.kernels.common import count_launches
    from repro_torch.kernels.streamk.grouped import (
        gemm_grouped_streamk, gemm_grouped_streamk_plain,
    )
    from repro_torch.kernels.streamk.ref import gemm_ref

    errs = {"grouped_streamk_sk": 0.0, "grouped_streamk_dp": 0.0}
    cases = bitwise = 0
    rng = np.random.default_rng(1)
    for gc, m, n, k in GROUPED_SHAPES + (GROUPED_RAGGED,):
        for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
            a, b, bias, operand = _grouped_operands(gc, m, n, k, dtype, gen)
            cfg = grouped_pick(gc, m, n, k, dtype).cfg
            ragged = (0, m) + tuple(int(s) for s in rng.integers(0, m + 1, size=gc - 2))
            for sizes in ((m,) * gc, ragged):
                dead = (torch.arange(m, device="cuda")[None, :]
                        >= torch.tensor(sizes, device="cuda")[:, None])[:, :, None]
                for epi, kw in ((Epilogue(), {}), (Epilogue(activation="gelu"), {}),
                                (Epilogue(bias=True), {"bias": bias}),
                                (Epilogue(binary="mul_silu"), {"operand": operand})):
                    what = f"B5 {gc}x{m}x{n}x{k} {dtype} {cfg.name} {epi.name} sizes={sizes}"
                    want = gemm_grouped_streamk_plain(a, b, sizes=sizes, out_dtype=dtype,
                                                      epilogue=epi, **kw)
                    ref = torch.zeros_like(want)
                    for i, s in enumerate(sizes):
                        if s:
                            ref[i, :s] = epi.apply(
                                gemm_ref(a[i, :s], b[i], torch.float32),
                                bias=None if "bias" not in kw else bias[i],
                                operand=None if "operand" not in kw else operand[i, :s],
                            ).to(dtype)
                    close(want, ref, tol, what + " plain vs gemm_ref")
                    for pol in ALL_POLICIES:
                        for g in (66, 132, 264):
                            got = gemm_grouped_streamk(a, b, policy=pol, cfg=cfg, g=g,
                                                       out_dtype=dtype, epilogue=epi,
                                                       group_sizes=sizes, **kw)
                            name = _grouped_kernel_name(pol)
                            label = f"{what} {pol.name} g={g}"
                            errs[name] = max(errs[name], close(got, want, tol, label),
                                             close(got, ref, tol, label + " vs gemm_ref"))
                            if torch.where(dead, got, 0).abs().max().item() != 0:
                                raise AssertionError(f"{label}: rows past a group's size are "
                                                     "not 0")
                            cases += 1
                for g in (66, 132, 264):
                    if _splits_tiles(sizes, n, k, cfg, g):
                        c1, c2 = (gemm_grouped_streamk(a, b, policy=ALL_SK, cfg=cfg, g=g,
                                                       group_sizes=sizes) for _ in range(2))
                        if not torch.equal(c1, c2):
                            raise AssertionError(f"B5 {gc}x{m}x{n}x{k} {cfg.name} g={g}: the "
                                                 "Stream-K form is not bitwise deterministic")
                        bitwise += 1
            with count_launches() as launched:
                out = gemm_grouped_streamk(a, b, policy=ALL_SK, cfg=cfg, g=132,
                                           group_sizes=(0,) * gc)
            if launched or out.any():
                raise AssertionError(f"B5 all-empty: launched {launched}, output not all 0")
    torch.cuda.synchronize()
    if not bitwise:
        raise AssertionError("no B5 case split a tile: the hand-off went untested")
    return errs, cases, bitwise


def time_grouped(gen):
    """B5 at olmoe-1b-7b's expert shapes (bf16, no epilogue) under the H100
    pick and under the other form, beside its plain version, ``torch.bmm``
    (the yardstick) and the bound. Each call reads 268 MB of weights, more
    than the 50 MB L2, so no rotation is needed."""
    import torch

    from repro_torch.core.policies import ALL_SK, DP, PolicyKind
    from repro_torch.kernels.streamk.grouped import (
        gemm_grouped_streamk, gemm_grouped_streamk_plain,
    )

    rows = []
    for gc, m, n, k in GROUPED_SHAPES:
        a, b, _, _ = _grouped_operands(gc, m, n, k, torch.bfloat16, gen)
        s = grouped_pick(gc, m, n, k, a.dtype)
        other = ALL_SK if s.policy.kind == PolicyKind.DP else DP

        def kernel(pol, a=a, b=b, s=s):
            return gemm_grouped_streamk(a, b, policy=pol, cfg=s.cfg, g=s.g)

        plain = gemm_grouped_streamk_plain(a, b, sizes=(m,) * gc, out_dtype=a.dtype)
        err = max(close(kernel(s.policy), plain, 2e-2, f"B5 timing {gc}x{m}x{n}x{k}"),
                  close(kernel(other), plain, 2e-2, f"B5 timing {gc}x{m}x{n}x{k} other"))
        ms, ev = time_ms(lambda: kernel(s.policy))
        other_ms, other_ev = time_ms(lambda: kernel(other))
        plain_ms, plain_ev = time_ms(
            lambda: gemm_grouped_streamk_plain(a, b, sizes=(m,) * gc, out_dtype=a.dtype), iters=3)
        lib, lib_ev = time_ms(lambda: torch.bmm(a, b))
        bnd, by = bound_ms((gc * m * k + gc * k * n + gc * m * n) * 2, 2 * gc * m * n * k)
        rows.append(dict(
            shape=[gc, m, n, k], kernel=_grouped_kernel_name(s.policy), policy=s.policy.name,
            tile=s.cfg.name, g=s.g, max_abs_err=err, ms=ms, event_ms=ev,
            other_kernel=_grouped_kernel_name(other), other_policy=other.name, other_ms=other_ms,
            other_event_ms=other_ev,
            plain_ms=plain_ms, plain_event_ms=plain_ev, library_ms=lib, library_event_ms=lib_ev,
            bound_ms=bnd, bound_by=by))
        log(f"  B5 {gc}x{m}x{n}x{k} {s.policy.name}/{s.cfg.name} g={s.g}: device {ms:.4f} ms, "
            f"events {ev:.4f} ms; {other.name} {other_ms:.4f} ms; plain {plain_ms:.4f} ms; "
            f"torch.bmm {lib:.4f} ms; bound {bnd:.4f} ms by {by}")
    return rows


def grouped_entry(rows, name):
    """The timing of kernel ``name`` for the kernels line: at the first
    shape where the H100 picks it, else the first where it ran as the other
    form."""
    for row in rows:
        if row["kernel"] == name:
            return dict(row)
    for row in rows:
        if row["other_kernel"] == name:
            return dict(row, kernel=name, policy=row["other_policy"], ms=row["other_ms"],
                        event_ms=row["other_event_ms"])
    raise AssertionError(f"{name} was never timed")


# ---------------------------------------------------------------------------
# Phase 3: serve granite-8b, then olmoe-1b-7b
# ---------------------------------------------------------------------------


def _kernels_of(entry):
    from repro_torch.core.workpart import GemmShape, partition

    sel = entry.selection
    if entry.op.fused:
        return {_grouped_kernel_name(sel.policy)}
    part = partition(GemmShape(*entry.local_mnk), sel.cfg, sel.g, sel.policy)
    names = set()
    if part.sk_tiles:
        names |= {"streamk_phase1", "streamk_fixup"}
    if part.dp_tiles:
        names.add("dp_gemm_region")
    return names


def phase_serve(arch):
    """Serve ``arch`` at full width on the ``cuda`` backend and check it
    (see the module docstring)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.gemm import gemm_context
    from repro_torch.kernels.common import LAUNCHES, count_launches, reset_launch_counts
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg = get_config(arch)
    model = LM(cfg)
    t0 = time.perf_counter()
    params = model.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    # every GEMM weight: stacked 2-D projections, routers and experts (the
    # norms are (L, D)), and lm_head
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params["layers"])
                       if t.dim() >= 3) + params["lm_head"].numel() * 2
    log(f"{arch} FULL: {n_params / 1e9:.3f} B parameters "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB on the card) in "
        f"{time.perf_counter() - t0:.1f}s")

    n_slots, max_seq = N_SLOTS, MAX_SEQ
    engine = ServeEngine(model, params, ServeConfig(n_slots=n_slots, max_seq=max_seq, eos=-1),
                         backend="cuda")
    prompts = serve_prompts(cfg.vocab_size)
    for p in prompts:
        engine.submit(p, max_new_tokens=8)

    reset_launch_counts()
    done = engine.run()
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)

    if len(done) != 4 or engine.exhausted:
        raise AssertionError(f"{arch}: served {len(done)}/4 requests")
    for r in done:
        if len(r.out_tokens) != 8 or not all(0 <= t < cfg.vocab_size for t in r.out_tokens):
            raise AssertionError(f"{arch} request {r.uid}: bad tokens {r.out_tokens}")
    needed = set()
    for e in engine.selection_log:
        needed |= _kernels_of(e)
    log(f"launches in the {arch} serve run: {launches}; the selections call for "
        f"{sorted(needed)}")
    if sum(launches.values()) <= 0:
        raise AssertionError(f"the {arch} serve run launched no kernel")
    for name in needed:
        if launches[name] <= 0:
            raise AssertionError(f"{arch}: {name} was selected but never launched")
    grouped = sum(1 for e in engine.selection_log if e.op.fused)
    b5 = launches["grouped_streamk_sk"] + launches["grouped_streamk_dp"]
    if b5 != grouped:
        raise AssertionError(f"{arch}: {b5} B5 launches for {grouped} grouped dispatches")

    # launches of one prefill and one decode step (outside the counted run)
    with count_launches() as pre:
        engine.prefill_logits(prompts[0])
    cur = torch.zeros(n_slots, dtype=torch.long, device="cuda")
    toks = torch.ones(n_slots, 1, dtype=torch.long, device="cuda")
    scratch_cache = model.init_cache(n_slots, max_seq, device="cuda")
    with count_launches() as dec, gemm_context(selector=engine.selector, backend="cuda"):
        model.decode_step(params, scratch_cache, toks, cur)
    b5_per_step = sum(1 for n in dec if n.startswith("grouped_streamk"))
    if cfg.family == "moe" and b5_per_step != 3 * cfg.n_layers:
        raise AssertionError(f"{arch}: {b5_per_step} B5 launches in a decode step, expected "
                             f"{3 * cfg.n_layers}")

    # a warm decode step, broken down; the same step with the torch backend
    # (library matmuls) is the yardstick for the time outside the GEMMs
    def step():
        model.decode_step(params, scratch_cache, toks, cur)

    breakdown = {}
    for backend in ("cuda", "torch"):
        with gemm_context(selector=engine.selector, backend=backend):
            breakdown[backend] = decode_breakdown(step)
    del scratch_cache
    for backend, bd in breakdown.items():
        log(f"warm decode step, {backend} backend: {bd['step_ms']:.2f} ms wall, "
            f"{bd['enqueue_ms']:.2f} ms host enqueue, device busy {bd['device_busy_ms']} ms "
            f"(GEMM kernels {bd['gemm_kernels_ms']} ms), idle share {bd['idle_share']}")
        for name, ms in bd["top_kernels"]:
            log(f"    {ms:9.3f} ms  {name}")
    per = lambda log_: {n: log_.count(n) for n in sorted(set(log_))}  # noqa: E731

    # the first request's prefill logits against the torch backend; for a
    # MoE model, count the routing choices the two backends made differently
    tol = LOGITS_TOL[arch]
    with routing_log() as routes_cuda:
        got = engine.prefill_logits(prompts[0])
    with routing_log() as routes_torch, gemm_context(backend="torch"):
        want, _ = model.prefill(params, torch.as_tensor(prompts[0], device="cuda")[None])
    flips = routing_flips(routes_cuda, routes_torch)
    if got.shape != (1, 1, cfg.vocab_size) or not torch.isfinite(got).all():
        raise AssertionError(f"{arch}: bad prefill logits {tuple(got.shape)}")
    diff = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if diff > tol * scale:
        raise AssertionError(f"{arch} prefill logits: max|diff| {diff:.4f} > {tol} * {scale:.4f} "
                             f"(routing flips: {flips})")
    same_top = int(got.float().argmax()) == int(want.float().argmax())
    # the same check must catch a kernel that skips a K chunk: B1 under the
    # DP policy for the dense model, B5 for the MoE model
    fault = planted_fault_diff(model, params, engine.selector, prompts[0], want,
                               grouped=cfg.family == "moe")
    if fault <= tol * scale:
        raise AssertionError(f"{arch}: the logits check missed a planted fault: max|diff| "
                             f"{fault:.4f} <= {tol} * {scale:.4f}")

    tm = engine.timing
    step_ms = tm["decode_s"] / max(tm["decode_steps"], 1) * 1e3
    floor_ms = weight_bytes / HBM_BW * 1e3
    st = engine.selector_stats
    picks = {}
    for e in engine.selection_log:
        s = e.selection
        g_part = f"G={e.op.g} " if e.op.kind == "grouped" else ""
        picks.setdefault(f"{e.tag} {g_part}{e.local_mnk}", f"{s.policy.name}/{s.cfg.name}/g{s.g}")
    serve = dict(
        arch=arch, requests=len(done), prompt_lens=[len(p) for p in prompts],
        prefill_tokens=tm["prefill_tokens"], prefill_s=tm["prefill_s"],
        prefill_tok_s=tm["prefill_tokens"] / tm["prefill_s"],
        decode_tokens=tm["decode_tokens"], decode_steps=tm["decode_steps"],
        decode_s=tm["decode_s"], decode_tok_s=tm["decode_tokens"] / tm["decode_s"],
        decode_step_ms=step_ms, decode_floor_ms=floor_ms, weight_bytes=weight_bytes,
        launches=launches, grouped_dispatches=grouped, launches_per_prefill=per(pre),
        prefill_len=len(prompts[0]), launches_per_decode_step=per(dec),
        decode_breakdown=breakdown, logits_max_abs_diff=diff, logits_max_abs=scale,
        logits_tol=tol, planted_fault_max_abs_diff=fault, same_argmax=same_top,
        routing_flips=flips,
        selector=dict(lookups=st.lookups, cache_hits=st.cache_hits, fallbacks=st.fallbacks),
        picks=picks, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    log(f"{arch} served 4/4: prefill {serve['prefill_tok_s']:.1f} tok/s, decode "
        f"{serve['decode_tok_s']:.1f} tok/s, decode step {step_ms:.2f} ms "
        f"(weight-read floor {floor_ms:.2f} ms)")
    log(f"launches per prefill ({len(prompts[0])} tokens): {serve['launches_per_prefill']}; "
        f"per decode step: {serve['launches_per_decode_step']}")
    log(f"prefill logits vs torch backend: max|diff| {diff:.4f} (max|logit| {scale:.4f}, "
        f"limit {tol * scale:.4f}), same argmax: {same_top}; planted fault {fault:.4f}; "
        f"routing flips {flips}")
    log(f"selector: {st.lookups} lookups, {st.cache_hits} cache hits, {st.fallbacks} cold picks")
    for key, val in sorted(picks.items()):
        log(f"  {key} -> {val}")
    return serve


@contextmanager
def routing_log():
    """Record each MoE layer's top-k expert choice ((T, k) indices) while the
    block runs, under whatever backend is active. The router GEMM is issued
    once more for the record; nothing else changes."""
    import torch

    from repro_torch.core.gemm import gemm
    from repro_torch.models import layers

    routes = []
    moe_apply = layers.moe_apply

    def recording(p, x, cfg, *, div):
        logits = gemm(x.reshape(-1, x.shape[-1]).float(), p["router"], tag="moe.router")
        routes.append(torch.topk(torch.softmax(logits, -1), cfg.top_k, dim=-1).indices)
        return moe_apply(p, x, cfg, div=div)

    layers.moe_apply = recording
    try:
        yield routes
    finally:
        layers.moe_apply = moe_apply


def routing_flips(routes_a, routes_b):
    """How two runs' routing differs: the (layer, token, rank) assignments
    that name another expert, and the (layer, token) pairs whose expert set
    differs (a swap of two ranks changes the first count, not the second)."""
    import torch

    assignments, tokens, where = 0, 0, []
    for layer, (ra, rb) in enumerate(zip(routes_a, routes_b)):
        ne = (ra != rb).nonzero().tolist()
        assignments += len(ne)
        where += [(layer, t, r) for t, r in ne][:8]
        tokens += int((torch.sort(ra, -1).values != torch.sort(rb, -1).values).any(-1).sum())
    return dict(layers=len(routes_a), assignments=assignments, token_sets=tokens,
                first=where[:8])


def planted_fault_diff(model, params, selector, prompt, want, *, grouped):
    """max|logit diff| against ``want`` of a prefill whose GEMMs of one kind
    drop their last K chunk (``cfg.bk`` of K): the DP-policy GEMMs (the
    reading a B1 that skips one chunk of its K loop would give), or, with
    ``grouped``, every fused grouped GEMM (a B5 that does the same)."""
    import torch

    from repro_torch.core.gemm import gemm_context, get_backend, register_backend
    from repro_torch.core.policies import DP

    cuda = get_backend("cuda")

    def drop_last_k_chunk(x, w, *, op, policy, cfg, **kw):
        hit = op.fused if grouped else policy == DP
        if hit and x.shape[-1] > cfg.bk:
            kk = x.shape[-1] - cfg.bk
            x, w = x[..., :kk].contiguous(), w[:, :kk].contiguous()
        return cuda(x, w, op=op, policy=policy, cfg=cfg, **kw)

    register_backend("cuda_planted_fault", drop_last_k_chunk, overwrite=True)
    with gemm_context(selector=selector, backend="cuda_planted_fault"):
        bad, _ = model.prefill(params, torch.as_tensor(prompt, device="cuda")[None])
    return (bad.float() - want.float()).abs().max().item()


#: name fragments of the hand-written kernels in profiler traces
GEMM_KERNELS = ("dp_kernel", "streamk_kernel", "fixup_kernel", "grouped_sk_kernel",
                "grouped_dp_kernel")


def decode_breakdown(step, iters=5):
    """Where a warm decode step's time goes: wall time (host clock ending in
    a synchronise), the host's enqueue time (until ``step`` returns), and,
    from one ``torch.profiler`` trace, the device's busy time, the share of
    it in the GEMM kernels, and the busiest kernels by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    enqueue = wall = 0.0
    for _ in range(iters):
        t0 = time.perf_counter()
        step()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enqueue += t1 - t0
        wall += time.perf_counter() - t0
    wall_ms, enqueue_ms = wall / iters * 1e3, enqueue / iters * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    by_name = device_ms_by_name(prof)
    busy = sum(by_name.values())
    gemm = sum(v for name, v in by_name.items() if any(f in name for f in GEMM_KERNELS))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(
        step_ms=wall_ms, enqueue_ms=enqueue_ms,
        # None when the trace holds no device events ("not measured")
        device_busy_ms=busy or None, gemm_kernels_ms=gemm if busy else None,
        idle_share=1.0 - busy / wall_ms if busy else None,
        top_kernels=[[name[:90], ms] for name, ms in top],
    )


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the H100", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 references stay f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi, build_s = phase_device()

    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    errs, cases = sweep(gen)
    log(f"sweep {SWEEP_SHAPES}: {cases} cases agree; max errors {errs} "
        f"({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    slice_err, picks = slice_shapes(gen, "granite-8b", GRANITE_NK)
    olmoe_err, olmoe_picks = slice_shapes(gen, "olmoe-1b-7b", OLMOE_NK)
    slice_err, picks = max(slice_err, olmoe_err), picks + olmoe_picks
    log(f"slice shapes: {len(picks)} shapes (granite-8b, olmoe-1b-7b) x (pick, dp, all_sk) "
        f"agree with gemm_ref, max err {slice_err:.3e}; B2+B3 bitwise deterministic "
        f"({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    b5_errs, b5_cases, b5_bitwise = sweep_grouped(gen)
    errs.update(b5_errs)
    log(f"B5 sweep {GROUPED_SHAPES + (GROUPED_RAGGED,)}: {b5_cases} cases agree with the plain "
        f"version and gemm_ref; max errors {b5_errs}; {b5_bitwise} split-tile cases bitwise "
        f"deterministic; all-empty launches nothing ({time.perf_counter() - t0:.1f}s)")
    timed = time_kernels(gen)
    log("main-path GEMMs, decode (M=4) and prompt (M=64):")
    gemms = time_main_path_gemms(gen, 4) + time_main_path_gemms(gen, 64)
    log("B5 at olmoe-1b-7b's expert shapes:")
    grouped_rows = time_grouped(gen)
    for name in ("grouped_streamk_sk", "grouped_streamk_dp"):
        timed[name] = grouped_entry(grouped_rows, name)

    serve = {"granite-8b": phase_serve("granite-8b")}
    gc.collect()  # granite's weights go before olmoe's arrive
    torch.cuda.empty_cache()
    serve["olmoe-1b-7b"] = phase_serve("olmoe-1b-7b")

    kernels = []
    for name in REPLACES:
        t = timed[name]
        # launches: each kernel's count from the main path that serves it
        arch = "olmoe-1b-7b" if name.startswith("grouped") else "granite-8b"
        extra = {key: t[key] for key in ("sweep_shape", "sweep_ms", "sweep_plain_ms",
                                         "library_of", "composed_ms") if key in t}
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=serve[arch]["launches"][name], max_abs_err=t["max_abs_err"], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"], shape=t["shape"], policy=t["policy"], tile=t["tile"],
            g=t["g"], sweep_max_err=errs[name], event_ms=t["event_ms"],
            plain_event_ms=t["plain_event_ms"], library_event_ms=t.get("library_event_ms"),
            launches_in=arch, launches_other_model=serve[
                "granite-8b" if arch != "granite-8b" else "olmoe-1b-7b"]["launches"][name],
            **extra,
        ))
    record = dict(card=smi, build_s=build_s, kernels=kernels, picks=picks, gemms=gemms,
                  grouped=grouped_rows, serve=serve, sweep_cases=cases, b5_cases=b5_cases,
                  b5_bitwise=b5_bitwise, slice_max_err=slice_err,
                  seconds=time.perf_counter() - t_start)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    log(f"total {record['seconds']:.1f}s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
