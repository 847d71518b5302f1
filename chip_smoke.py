#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Device: a CUDA card of capability (9, 0); prints the card's name and
   power limit, builds the hand-written kernels from ``src/repro_torch/csrc``
   with nvcc and prints the build time and the ptxas register/spill report.
2. Kernels against their plain PyTorch versions, on the card:
   * the full sweep at M=64, N=4096, K=4096 (and two small ragged shapes,
     one per staging path): all 8 policies x 2 grid sizes x {bf16 (2e-2),
     f32 (1e-4)} x epilogues {none, mul_silu, bias+gelu};
     B2's partials against the plain phase 1 (the contributor slots), B3's
     and B1's C against their plain versions, the composed C against the
     f32-accumulated ``gemm_ref``;
   * granite-8b's projection shapes, M in {1, 4, 64} and each served
     prompt length x (N, K) in the slice, bf16, under the H100 selector's
     pick, DP and ALL_SK, against ``gemm_ref``; B2+B3 bitwise identical
     across two runs;
   * each kernel timed with CUDA events at a decode shape it serves (device
     time of calls queued to run back to back, and the time of calls as the
     host issues them; see ``time_ms``), beside
     its plain version, ``torch.matmul`` (the yardstick, B1 only) and its
     bound (bytes over 3.35 TB/s or operations over 989 TFLOP/s, whichever
     is larger).
3. Serve: granite-8b at full width (36 layers, d_model 4096, bf16, ~16.5 GB
   of seeded random weights) through ``ServeEngine`` on the ``cuda``
   backend: 4 slots, max_seq 256, 4 seeded requests of 16-64 tokens, 8 new
   tokens each. The launch counters are zeroed just before and read just
   after; every kernel the selections call for must have launched. The
   first request's prefill logits are held against the ``torch`` backend on
   the same weights, and so are the logits of a planted fault (the DP
   composition's GEMMs with their last K chunk dropped), which must fail
   that limit. A warm decode step is then broken down (wall time, host
   enqueue time, device busy time from ``torch.profiler``) under the
   ``cuda`` backend and, as the yardstick, the ``torch`` backend.

Tolerances: a kernel output ``x`` agrees with its reference ``r`` when
``max|x - r| <= tol * max(1, max|r|)``: 1e-4 for f32 inputs (f32 sums in
another order), 2e-2 for bf16 (one bf16 rounding of the output). The served
logits agree within 3e-2 * max|logit|: 36 layers of bf16 activations
rounded at different points of two summation orders (a sound run reads
about 1.7e-2 on the seeded weights).

The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BF16 = 989e12  # FLOP/s, H100 SXM dense tensor-core peak (data sheet)
PEAK_F32 = 67e12  # FLOP/s, H100 SXM f32 outside the tensor cores
HBM_BW = 3.35e12  # B/s, H100 SXM HBM3 (data sheet)
SLICE_NK = [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336), (49152, 4096)]
REPLACES = {
    "dp_gemm_region": "src/repro/kernels/dp/dp_gemm.py:40",
    "streamk_phase1": "src/repro/kernels/streamk/streamk_gemm.py:78",
    "streamk_fixup": "src/repro/kernels/streamk/streamk_gemm.py:179",
}
SOURCE = "src/repro_torch/csrc/stream_k.cu"
LOGITS_TOL = 3e-2  # served prefill logits vs the torch backend, x max|logit|
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
    log(f"kernels built from {SOURCE} in {build_s:.1f}s -> {cuda_lib.build_info['path']}")
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


def slice_ms():
    """The M of every GEMM the served run issues: lm_head's single row, the
    decode batch, the sweep's 64 and each prompt's prefill length (ragged
    edges inside a 64-row sub-block)."""
    from repro_torch.configs import get_config

    lens = {len(p) for p in serve_prompts(get_config("granite-8b").vocab_size)}
    return sorted({1, N_SLOTS, 64} | lens)


def slice_shapes(gen):
    """granite-8b's projection shapes under the H100 pick, DP and ALL_SK."""
    import torch

    from repro_torch.core.gemm import dtype_name
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
    for m in slice_ms():
        for n, k in SLICE_NK:
            a, b, _, _ = _operands(m, n, k, torch.bfloat16, gen)
            s = sel.select_op(GemmOp.plain(m, n, k, in_dtype=dtype_name(a.dtype)))
            picks.append({"m": m, "n": n, "k": k, "policy": s.policy.name, "tile": s.cfg.name,
                          "g": s.g})
            want = gemm_ref(a, b, torch.float32)
            for pol, cfg, g in ((s.policy, s.cfg, s.g), (DP, s.cfg, s.g), (ALL_SK, s.cfg, s.g)):
                c = ops.gemm(a, b, policy=pol, cfg=cfg, g=g)
                worst = max(worst, close(c, want, 2e-2, f"{m}x{n}x{k} {pol.name} {cfg.name}"))
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
    out["streamk_phase1"] = dict(shape=[m, n, k], policy=s.policy.name, tile=s.cfg.name, g=s.g,
                                 max_abs_err=err2, ms=ms2, plain_ms=plain2, bound_ms=bnd2,
                                 bound_by=by2, library_ms=None, event_ms=ev2,
                                 plain_event_ms=plain_ev2)
    c = torch.empty(m, n, dtype=a.dtype, device="cuda")
    c_p = torch.empty_like(c)
    err3 = close(streamk_fixup(p_k, part, c), streamk_fixup_plain(p_k, part, c_p), 2e-2,
                 "B3 timing")
    ms3, ev3 = time_ms(lambda: streamk_fixup(p_k, part, c))
    plain3, plain_ev3 = time_ms(lambda: streamk_fixup_plain(p_k, part, c_p))
    bnd3, by3 = bound_ms(slot_bytes + elems * 2, adds, PEAK_F32)
    out["streamk_fixup"] = dict(shape=[m, n, k], policy=s.policy.name, tile=s.cfg.name, g=s.g,
                                max_abs_err=err3, ms=ms3, plain_ms=plain3, bound_ms=bnd3,
                                bound_by=by3, library_ms=None, event_ms=ev3,
                                plain_event_ms=plain_ev3)

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
# Phase 3: serve granite-8b
# ---------------------------------------------------------------------------


def _kernels_of(entry):
    from repro_torch.core.workpart import GemmShape, partition

    sel = entry.selection
    part = partition(GemmShape(*entry.local_mnk), sel.cfg, sel.g, sel.policy)
    names = set()
    if part.sk_tiles:
        names |= {"streamk_phase1", "streamk_fixup"}
    if part.dp_tiles:
        names.add("dp_gemm_region")
    return names


def phase_serve():
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.gemm import gemm_context
    from repro_torch.kernels.common import LAUNCHES, count_launches, reset_launch_counts
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg = get_config("granite-8b")
    model = LM(cfg)
    t0 = time.perf_counter()
    params = model.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(
        t.numel() for t in _leaves(params)
    )
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params["layers"])
                       if t.dim() == 3) + params["lm_head"].numel() * 2
    log(f"granite-8b FULL: {n_params / 1e9:.3f} B parameters "
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
        raise AssertionError(f"served {len(done)}/4 requests")
    for r in done:
        if len(r.out_tokens) != 8 or not all(0 <= t < cfg.vocab_size for t in r.out_tokens):
            raise AssertionError(f"request {r.uid}: bad tokens {r.out_tokens}")
    needed = set()
    for e in engine.selection_log:
        needed |= _kernels_of(e)
    log(f"launches in the serve run: {launches}; the selections call for {sorted(needed)}")
    if sum(launches.values()) <= 0:
        raise AssertionError("the serve run launched no kernel")
    for name in needed:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was selected but never launched")

    # launches of one prefill and one decode step (outside the counted run)
    with count_launches() as pre:
        engine.prefill_logits(prompts[0])
    cur = torch.zeros(n_slots, dtype=torch.long, device="cuda")
    toks = torch.ones(n_slots, 1, dtype=torch.long, device="cuda")
    scratch_cache = model.init_cache(n_slots, max_seq, device="cuda")
    with count_launches() as dec, gemm_context(selector=engine.selector, backend="cuda"):
        model.decode_step(params, scratch_cache, toks, cur)

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

    # the first request's prefill logits against the torch backend
    got = engine.prefill_logits(prompts[0])
    with gemm_context(backend="torch"):
        want, _ = model.prefill(params, torch.as_tensor(prompts[0], device="cuda")[None])
    if got.shape != (1, 1, cfg.vocab_size) or not torch.isfinite(got).all():
        raise AssertionError(f"bad prefill logits {tuple(got.shape)}")
    diff = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if diff > LOGITS_TOL * scale:
        raise AssertionError(f"prefill logits: max|diff| {diff:.4f} > {LOGITS_TOL} * {scale:.4f}")
    same_top = int(got.float().argmax()) == int(want.float().argmax())
    # the same check must catch a kernel that skips a K chunk
    fault = planted_fault_diff(model, params, engine.selector, prompts[0], want)
    if fault <= LOGITS_TOL * scale:
        raise AssertionError(f"the logits check missed a planted fault: max|diff| {fault:.4f} "
                             f"<= {LOGITS_TOL} * {scale:.4f}")

    tm = engine.timing
    step_ms = tm["decode_s"] / max(tm["decode_steps"], 1) * 1e3
    floor_ms = weight_bytes / HBM_BW * 1e3
    st = engine.selector_stats
    picks = {}
    for e in engine.selection_log:
        s = e.selection
        picks.setdefault(f"{e.tag} {e.local_mnk}", f"{s.policy.name}/{s.cfg.name}/g{s.g}")
    serve = dict(
        requests=len(done), prompt_lens=[len(p) for p in prompts],
        prefill_tokens=tm["prefill_tokens"], prefill_s=tm["prefill_s"],
        prefill_tok_s=tm["prefill_tokens"] / tm["prefill_s"],
        decode_tokens=tm["decode_tokens"], decode_steps=tm["decode_steps"],
        decode_s=tm["decode_s"], decode_tok_s=tm["decode_tokens"] / tm["decode_s"],
        decode_step_ms=step_ms, decode_floor_ms=floor_ms, weight_bytes=weight_bytes,
        launches=launches, launches_per_prefill=per(pre), prefill_len=len(prompts[0]),
        launches_per_decode_step=per(dec), decode_breakdown=breakdown,
        logits_max_abs_diff=diff, logits_max_abs=scale, logits_tol=LOGITS_TOL,
        planted_fault_max_abs_diff=fault, same_argmax=same_top,
        selector=dict(lookups=st.lookups, cache_hits=st.cache_hits, fallbacks=st.fallbacks),
        picks=picks, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    log(f"served 4/4: prefill {serve['prefill_tok_s']:.1f} tok/s, decode "
        f"{serve['decode_tok_s']:.1f} tok/s, decode step {step_ms:.2f} ms "
        f"(weight-read floor {floor_ms:.2f} ms)")
    log(f"launches per prefill ({len(prompts[0])} tokens): {serve['launches_per_prefill']}; "
        f"per decode step: {serve['launches_per_decode_step']}")
    log(f"prefill logits vs torch backend: max|diff| {diff:.4f} (max|logit| {scale:.4f}, "
        f"limit {LOGITS_TOL * scale:.4f}), same argmax: {same_top}; planted fault "
        f"{fault:.4f}")
    log(f"selector: {st.lookups} lookups, {st.cache_hits} cache hits, {st.fallbacks} cold picks")
    for key, val in sorted(picks.items()):
        log(f"  {key} -> {val}")
    return serve


def planted_fault_diff(model, params, selector, prompt, want):
    """max|logit diff| against ``want`` of a prefill whose DP-policy GEMMs
    drop their last K chunk (``cfg.bk`` of K): the reading a B1 that skips
    one chunk of its K loop would give."""
    import torch

    from repro_torch.core.gemm import gemm_context, get_backend, register_backend
    from repro_torch.core.policies import DP

    cuda = get_backend("cuda")

    def drop_last_k_chunk(x, w, *, policy, cfg, **kw):
        if policy == DP and x.shape[-1] > cfg.bk:
            kk = x.shape[-1] - cfg.bk
            x, w = x[..., :kk].contiguous(), w[:, :kk]
        return cuda(x, w, policy=policy, cfg=cfg, **kw)

    register_backend("cuda_planted_fault", drop_last_k_chunk, overwrite=True)
    with gemm_context(selector=selector, backend="cuda_planted_fault"):
        bad, _ = model.prefill(params, torch.as_tensor(prompt, device="cuda")[None])
    return (bad.float() - want.float()).abs().max().item()


#: name fragments of the hand-written kernels in profiler traces
GEMM_KERNELS = ("dp_kernel", "streamk_kernel", "fixup_kernel")


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
    slice_err, picks = slice_shapes(gen)
    log(f"slice shapes: {len(picks)} shapes x (pick, dp, all_sk) agree with gemm_ref, max err "
        f"{slice_err:.3e}; B2+B3 bitwise deterministic ({time.perf_counter() - t0:.1f}s)")
    timed = time_kernels(gen)
    log("main-path GEMMs, decode (M=4) and prompt (M=64):")
    gemms = time_main_path_gemms(gen, 4) + time_main_path_gemms(gen, 64)

    serve = phase_serve()

    kernels = []
    for name in ("dp_gemm_region", "streamk_phase1", "streamk_fixup"):
        t = timed[name]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=serve["launches"][name], max_abs_err=t["max_abs_err"], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"], shape=t["shape"], policy=t["policy"], tile=t["tile"],
            g=t["g"], sweep_max_err=errs[name], event_ms=t["event_ms"],
            plain_event_ms=t["plain_event_ms"], library_event_ms=t.get("library_event_ms"),
            sweep_shape=t["sweep_shape"], sweep_ms=t["sweep_ms"], sweep_plain_ms=t["sweep_plain_ms"],
        ))
    record = dict(card=smi, build_s=build_s, kernels=kernels, picks=picks, gemms=gemms,
                  serve=serve, sweep_cases=cases, slice_max_err=slice_err,
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
