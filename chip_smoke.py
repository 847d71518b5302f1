#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Device: a CUDA card of capability (9, 0); prints the card's name and
   power limit, builds the hand-written kernels from ``src/repro_torch/csrc``
   (one nvcc per source, all at once) and prints the build time and the
   ptxas register/spill report.
2. Kernels against their plain PyTorch versions, on the card:
   * B1 and B2 (with B3, the fix-up, fused into its tail: one launch per
     Stream-K region), the full sweep at M=64, N=4096, K=4096 (and two small
     ragged shapes, one per staging path; with bf16 activations B1's and
     B2's sub-blocks run the tensor-core mainloop of ``csrc/mma_bf16.cuh``,
     with int8 ones that of ``csrc/mma_s8.cuh``): all
     8 policies x 2 grid sizes x {bf16 (2e-2), f32 (1e-4)} x epilogues
     {none, mul_silu, bias+gelu}; the split tiles' contributor slots against
     the plain sweep, the Stream-K region's C against the plain sweep then
     the plain fix-up, B1's C against its plain version, the composed C
     against the f32-accumulated ``gemm_ref``;
   * the plain projection shapes of granite-8b and olmoe-1b-7b (attention,
     MLP, router in f32, lm_head), M in {1, 4, 64} and each served prompt
     length, under the H100 selector's pick, DP and ALL_SK, against
     ``gemm_ref``; the Stream-K region bitwise identical across two runs;
   * B5, the grouped kernel, at olmoe-1b-7b's expert shapes (64 experts x
     4 or 16 rows, 2048 -> 1024 and 1024 -> 2048) and a small unaligned one:
     every policy x g in {66, 132, 264} x {bf16, f32} x epilogues {none,
     gelu, bias, mul_silu} x group sizes {full, ragged with empty groups}
     against its plain version and per-group ``gemm_ref``; all-empty sizes
     launch nothing; the Stream-K form with split tiles is bitwise
     deterministic (bf16 activations run the tensor-core mainloop of
     ``csrc/mma_bf16.cuh``, int8 ones that of ``csrc/mma_s8.cuh``, f32 ones
     the f32 FMA mainloop of ``csrc/fma_f32.cuh``);
   * each kernel timed with CUDA events at a decode shape it serves (device
     time of calls queued to run back to back, and the time of calls as the
     host issues them; see ``time_ms``), beside its plain version, one
     library call computing the same function (``torch.matmul`` for B1 and
     for the Stream-K region, which computes the whole GEMM under ALL_SK;
     ``torch.bmm`` for B5) and its
     bound (bytes over 3.35 TB/s or operations over 989 TFLOP/s, whichever
     is larger);
   * the quantization ladder (int8 and packed int4 weights with their
     per-output-channel scales; int8 activations with per-row scales and an
     int32 MAC): B1 and the Stream-K region through ``ops.gemm`` and each on
     its own, and both B5
     forms, on each of the six operand pairs (f32 or bf16 x int8, int8 x
     int8, f32 or bf16 or int8 x int4), every policy x g in {66, 132, 264} x the
     epilogues, at the sweep shapes plus an odd K and at the grouped shapes
     (ragged sizes, odd K), against the plain versions and
     dequantize-then-matmul; the Stream-K forms bitwise deterministic; then
     each served rung's kernels timed at the decode (M = 4) and prompt
     (M = 57) shapes, beside the plain version, the bound at the int8/int4
     widths of B, and a yardstick (``torch._int_mm`` for int8 x int8, its M
     padded to a size it takes; else ``torch.matmul``/``torch.bmm`` on the
     dequantized bf16 weight, a dense yardstick); int8 x int4 is timed the
     same way (rung ``int4-dynamic``, which no serve rung reaches); B5's
     bf16-activation rungs (bf16, bf16 x int8, bf16 x int4) in both forms are
     then printed as one table beside the times of the SIMT mainloop they
     replaced (``B5_SIMT_MS``), the bound and ``torch.bmm``, and so are its
     int8-activation rungs (int8-dynamic and int4-dynamic, now on the s8
     tensor-core mainloop of ``csrc/mma_s8.cuh``, beside ``B5_S8_SIMT_MS``),
     and B1 and the B2+B3 composition at their decode shapes, on the
     bf16-activation rungs (``B12_SIMT_MS``) and on the int8-activation ones
     (now on ``csrc/mma_s8.cuh``, beside ``B12_S8_SIMT_MS``), beside the
     library call; and B1, B2+B3 and both B5 forms on f32 activations, with
     f32, int8 and packed int4 weights (the f32 FMA mainloop of
     ``csrc/fma_f32.cuh``) beside
     ``torch.matmul``/``torch.bmm`` in f32, B1's and B2's calls also held
     against their plain versions (``F32_TABLE``, ``F32_PAIRS``);
   * B6, the split-K baseline, on every operand pair (f32, bf16 and the six
     quantized ones; bf16 activations run ``csrc/mma_bf16.cuh``'s
     tensor-core mainloop, int8 ones ``csrc/mma_s8.cuh``'s, f32 ones the
     f32 FMA mainloop of ``csrc/fma_f32.cuh``) x s in {1, 2, 4, 8} x g in
     {0, 66, 132, 264} at the sweep shape, a ragged unaligned one, an odd K
     and K < bk * s: its partials against ``splitk_partials_plain`` (empty
     splits read 0),
     ``splitk.ops.gemm`` against ``gemm_ref`` or dequantize-then-matmul, two
     runs bitwise identical, and a planted fault (the reduction drops the
     last split) that must read at least 3 times its limit; each pair's
     launches counted;
   * the slice's main path, the baseline comparison: at granite-8b's five
     projection shapes, M = 4 and 57, bf16, the H100 pick (the whole
     composition), ``dp.ops.gemm`` and ``splitk.ops.gemm`` at s in
     {2, 4, 8} with the pick's tile, each once against ``gemm_ref`` with the
     launch counters zeroed just before and read just after (every B6 call
     must have launched), then each timed beside ``torch.matmul``; B6 timed
     alone at 4x14336x4096, s = 4, on all eight pairs (``time_splitk``:
     first held against its plain version, int8 activations bitwise),
     beside the plain version, the library call of the whole GEMM and the
     bound; its bf16 row goes to the ``kernels`` line;
   * ``gemm_batched`` through the ``cuda`` backend at B = 4, granite-8b's
     4096 -> 14336 at M = 4, f32, against ``torch.bmm``: B times the pick's
     launches.
3. Serve, through ``ServeEngine`` on the ``cuda`` backend, 4 slots, max_seq
   256, 4 seeded requests of 16-64 tokens, 8 new tokens each, with seeded
   random weights: granite-8b at full width (36 layers, d_model 4096, bf16,
   ~16.5 GB), then, its weights freed, olmoe-1b-7b at full width (16 layers,
   d_model 2048, 64 experts top-8, bf16, ~13.8 GB); each dense, then on each
   rung (``int8``, ``int8-dynamic``, ``int4``), quantized from the same bf16
   weights, each quantized tree freed before the next. For each run, the
   launch counters are zeroed just before it and read just after; every
   kernel (and rung) the selections call for must have launched, every
   quantized projection must have run on its rung, and each fused grouped
   dispatch must be exactly one B5 launch (48 per olmoe decode step). The
   first request's prefill logits are held against the ``torch`` backend on
   the same weights (for olmoe the routing choices the two backends made
   differently are counted; its dense run holds the reading with the
   ``torch`` backend replaying the ``cuda`` run's top-8 choices, and the
   router GEMM on its own, see below), and so are the logits of a planted
   fault, read the same way, which must read at least 3 times that limit:
   granite's DP GEMMs, or olmoe's grouped GEMMs, with their last K chunk
   dropped. A quantized
   run's logits are also compared with the dense run's (quantization error,
   reported, not limited). A warm decode step is then broken down (wall
   time, host enqueue time, device busy time from ``torch.profiler``) under
   the ``cuda`` backend and, as the yardstick, the ``torch`` backend.
   Between the two models, granite-8b at full width and 2 layers with the
   int8 KV cache (``kv_cache_dtype="int8"``): served on the ``cuda`` backend
   with its launch counts read as above, then the decode logits of the
   first prompt (prefill and two decode steps) held against the ``torch``
   backend under granite's ``LOGITS_TOL`` and compared with the
   model-dtype cache (reported).
4. Tune (``phase_tune``): online adaptation on the card. granite-8b at full
   width serves the same four requests through a cold selector (nominal
   H100, Hopper tiles, an empty database and sieve) whose
   ``AdaptiveTuner`` (``hot_threshold=1``, one round a decode step, top-5
   budget) times each missed fingerprint on the hand-written kernels with
   ``measure_wallclock`` and journals it to a temporary directory; then
   olmoe-1b-7b at full width and ``TUNE_OLMOE_LAYERS`` layers, for the
   fused grouped fingerprints. The journal is replayed into a fresh
   database (its snapshot round trip must give equal records), calibrated
   (the bf16 profile must fit on at least ``MIN_RECORDS`` records; the
   baseline comparison's shapes are tuned besides when the served ones
   give fewer), and sieved (true-negative rate 1.0). granite-8b is served
   again from that warm ``SelectorState``, launch counters zeroed just
   before and read just after: every dispatch must be a database hit, every
   kernel its picks call for must launch, and its prefill logits hold
   ``LOGITS_TOL`` against the ``torch`` backend. Reported: the phase's
   seconds, measurements and records, the winners by policy and g, the
   sieve's elimination rate over the tuned keys, the fitted terms beside
   the nominal ones, each winner's model rank under the nominal machine
   and under the calibration, and a warm decode step's GEMM ms with the
   tuned picks beside the nominal model's (``kernel_ab.py --tuned`` times
   each decode projection's two picks on their own). The tuner's times
   keep the weights in L2 and are issued by the host back to back (the
   paper's protocol), unlike phase 2's.
5. Paged serving and the fleet (``phase_paged``), on the ``cuda`` backend,
   page size 16, the equal-memory pool of 64 pages, 4 active, max_seq 256:
   (a) granite-8b at full width on phase 3's bf16 weights (run at the end
   of its phase 3, before they are freed): the four prompts through
   ``PagedServeEngine`` with whole-prompt prefill and with chunks of 16,
   launch counters zeroed just before each run and read just after (B1 and
   B2 must launch, and every kernel the selections call for), the greedy
   tokens set beside phase 3's dense run (reported); one paged decode step
   held against the dense engine's step on the same prefilled requests, and
   the chunked prefill's last-chunk logits against the whole prompt's, both
   at ``LOGITS_TOL``, with a planted fault each that must read at least 3
   times the limit (request 0's first page-table entry pointing at request
   1's first page; the last chunk attending over a zeroed prefix); the
   gather of a decode step's largest view timed on its own. (b) olmoe-1b-7b
   at full width and ``PAGED_OLMOE_LAYERS`` layers, paged with chunks of 16:
   one B5 launch per fused grouped dispatch, the chunked logits against the
   ``torch`` backend replaying the run's top-8 choices chunk by chunk at
   olmoe's ``LOGITS_TOL``, the router at ``ROUTER_TOL``, and the same
   planted fault. (c) The serve CLI (``repro_torch.launch.serve.main``) at
   full width: granite-8b, ``--paged --prefill-chunk 16 --replay poisson
   --requests 8 --workers 2 --adapt --adapt-every 1 --top-k 5
   --gossip-every 2`` into a temporary journal (worker 1's gossip must
   absorb entries), then the same command with ``--merge-journals`` and
   without ``--adapt`` (every decode dispatch must be a database hit); both
   exit 0 with every request completed, B1 and B2 launched. Reported: the
   phase's seconds, wall ms per decode step paged beside dense, peak pages
   and residents, admission counters, the step SLO percentiles, gossip
   rounds and entries, and the fleet's merged records and conflicts.

Tolerances: a kernel output ``x`` agrees with its reference ``r`` when
``max|x - r| <= tol * max(1, max|r|)``: 1e-4 for f32 inputs (f32 sums in
another order), 2e-2 for bf16 (one bf16 rounding of the output). The served
logits agree within ``LOGITS_TOL`` x max|logit|: 3e-2 for granite-8b's 36
layers of bf16 activations rounded at different points of two summation
orders (a sound run reads about 1.7e-2 on the seeded weights), and 5e-2 for
olmoe-1b-7b. There the same roundings also flip near-tied top-8 routing
choices (the run counts them), and each flip moves the logits further: with
each backend routing on its own, sound implementations that only sum K in
another order read 4.7e-2 to 6.3e-2 against the ``torch`` backend
(``logits_probe.py --spread``), so that reading cannot hold a 5e-2 limit.
olmoe's dense run therefore holds the limit on the reading with the
``torch`` backend replaying the ``cuda`` run's top-8 choices
(``routing_replay``: the kernels' rounding without the flips it sets off,
7.8e-3 to 8.7e-3), and, so that the replay hides no fault of the router's
own GEMM, holds each layer's router logits against ``torch.matmul`` of the
same input at the f32 kernel tolerance (``ROUTER_TOL``); the reading with
each backend routing alone is reported. Its planted fault is read with the
fault run's choices replayed. The quantized kernels keep 1e-4 for
f32 activations (the int8 -> f32 widening is exact and the int8 x int8
k-steps are exact int32 sums) and 2e-2 for bf16 ones; the quantized runs'
logits limits are ``QUANT_LOGITS_TOL``, set from sound readings with each
backend routing alone (so they hold that reading, the replayed one is
reported), and every planted fault must read at least 3 times its limit.

The line before the last is the ``kernels`` JSON: every kernel (B6's launches
from the baseline comparison, the others' from the served runs), and one entry
per (kernel, rung) that a served path ran; each entry names the mainloop
it ran (``mainloop``: ``mma`` or ``fma``); B3 has no entry of its own, being
fused into B2 (``streamk_phase1``); the last line is ``{"ok": true,
"device": {...}}``. Details go to ``chiprun_out/chip_smoke.json``.
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
    "grouped_streamk_sk": "src/repro/kernels/streamk/grouped.py:93",
    "grouped_streamk_dp": "src/repro/kernels/streamk/grouped.py:156",
    "splitk_partials": "src/repro/kernels/splitk/splitk_gemm.py:28",
}
SOURCE = "src/repro_torch/csrc/stream_k.cuh"  # instantiated by stream_k.cu and quant_*.cu
GROUPED_SOURCE = "src/repro_torch/csrc/grouped.cuh"  # by grouped.cu, grouped_bf16.cu, quant_*.cu
SOURCES = dict.fromkeys(("dp_gemm_region", "streamk_phase1"), SOURCE)
SOURCES.update(dict.fromkeys(("grouped_streamk_sk", "grouped_streamk_dp"), GROUPED_SOURCE))
SOURCES["splitk_partials"] = "src/repro_torch/csrc/splitk.cuh"  # by stream_k.cu and quant_*.cu
#: the kernels a served path runs (B6 has no served caller)
SERVED_KERNELS = [name for name in REPLACES if name != "splitk_partials"]
PEAK_INT8 = 1979e12  # OP/s, H100 SXM dense int8 tensor-core peak (data sheet)
#: the quantization ladder as served (bf16 activations): rung -> (bits, act_bits, the source
#: that instantiates its B1, B2 and B5)
RUNGS = {"int8": (8, None, "src/repro_torch/csrc/quant_bf16_i8.cu"),
         "int8-dynamic": (8, 8, "src/repro_torch/csrc/quant_i8_i8.cu"),
         "int4": (4, None, "src/repro_torch/csrc/quant_bf16_i4.cu")}
#: the quantized sweep's operand pairs: (name, activation dtype, weight bits, int8
#: activations, tolerance); f32 activations keep 1e-4 (the int8 -> f32 widening is exact and
#: the int8 x int8 k-steps are exact int32 sums), bf16 ones 2e-2
QUANT_PAIRS = (("f32*int8", "float32", 8, False, 1e-4), ("bf16*int8", "bfloat16", 8, False, 2e-2),
               ("int8*int8", "float32", 8, True, 1e-4), ("f32*int4", "float32", 4, False, 1e-4),
               ("bf16*int4", "bfloat16", 4, False, 2e-2), ("int8*int4", "float32", 4, True, 1e-4))
#: the rungs timed in phase 2: the served ones, and int4 weights against int8 activations
#: (``quantize_weight(bits=4, act_bits=8)``), which no serve rung reaches
TIMED_RUNGS = dict(RUNGS, **{"int4-dynamic": (4, 8, "src/repro_torch/csrc/quant_i8_i4.cu")})
#: served prefill logits vs the torch backend, x max|logit|, per model: a
#: sound granite-8b run reads 1.7e-2 and its planted fault 0.39; olmoe-1b-7b's
#: limit holds the reading with the torch backend replaying the cuda run's
#: top-8 choices (7.8e-3 to 8.7e-3 on the H100; each backend routing alone
#: reads 2.3e-2 to 6.3e-2 between sound implementations, from routing flips)
LOGITS_TOL = {"granite-8b": 3e-2, "olmoe-1b-7b": 5e-2}
#: a MoE layer's router logits (an f32 GEMM) against ``torch.matmul`` of the
#: same input, x max(1, max|ref|): the f32 kernel tolerance
ROUTER_TOL = 1e-4
#: the limits of the quantized runs, against the torch backend on the same quantized weights,
#: from their sound readings on the H100 (x max|logit|): granite-8b reads 1.96e-2 (int8), 0
#: (int8-dynamic: the per-row int8 requantization of every activation absorbs the two
#: backends' roundings, so the logits come out bit-identical) and 1.90e-2 (int4), so it keeps
#: its dense 3e-2; olmoe-1b-7b reads 4.46e-2, 0 and 8.17e-2, its routing flips compounding on
#: the coarser weights, so 7e-2, 5e-2 (its dense limit) and 1.2e-1. The planted fault of a
#: quantized run, every DP and grouped GEMM on the rung dropping its last K chunk, must read
#: at least 3 times the limit.
QUANT_LOGITS_TOL = {
    ("granite-8b", "int8"): 3e-2, ("granite-8b", "int8-dynamic"): 3e-2,
    ("granite-8b", "int4"): 3e-2, ("olmoe-1b-7b", "int8"): 7e-2,
    ("olmoe-1b-7b", "int8-dynamic"): 5e-2, ("olmoe-1b-7b", "int4"): 1.2e-1,
}
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
    """(sk_tiles, mc + 1, 1, 1): the contributor slots of split tiles, below
    the tile's contributor count: those the card defines on every pair (a
    tile that one block owns whole is flushed from registers; dense f32
    parks it in slot 0 first)."""
    import torch

    from repro_torch.kernels.streamk.streamk_gemm import n_contributors

    nc = n_contributors(part, partials.device)
    used = torch.arange(partials.shape[1], device=partials.device)[None, :] < nc[:, None]
    return (used & (nc > 1)[:, None])[:, :, None, None]


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
        streamk_fixup_plain, streamk_phase1_plain, streamk_region,
    )
    from repro_torch.core.op import GemmOp
    from repro_torch.core.gemm import dtype_name

    errs = {"dp_gemm_region": 0.0, "streamk_phase1": 0.0, "gemm": 0.0}
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
                        _, p_k = streamk_region(a, b, part, c_k, epilogue=epi, workspace=True,
                                                **kw)
                        p_p = streamk_phase1_plain(a, b, part)
                        used = _used_slots(p_k, part)
                        streamk_fixup_plain(p_p, part, c_p, epilogue=epi, **kw)
                        errs["streamk_phase1"] = max(
                            errs["streamk_phase1"],
                            close(torch.where(used, p_k, 0.0), torch.where(used, p_p, 0.0), tol,
                                  what + " B2 slots"),
                            close(c_k, c_p, tol, what + " B2+B3"))
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
    from repro_torch.kernels.streamk.streamk_gemm import streamk_region

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
            # determinism: the sweep with its ordered fix-up is bit-identical
            part = partition(GemmShape(m, n, k), s.cfg, s.g, ALL_SK)
            c1 = streamk_region(a, b, part, torch.empty(m, n, dtype=a.dtype, device="cuda"))
            c2 = streamk_region(a, b, part, torch.empty(m, n, dtype=a.dtype, device="cuda"))
            if not torch.equal(c1, c2):
                raise AssertionError(f"{m}x{n}x{k}: B2+B3 not bitwise deterministic")
    torch.cuda.synchronize()
    return worst, picks


def _rotating(b, min_bytes=200 * 2**20):
    """Copies of a weight whose total exceeds the 50 MB L2, so timed calls
    read it from device memory as a decode step does."""
    copies = max(1, math.ceil(min_bytes / (b.numel() * b.element_size())))
    return [b.clone() for _ in range(copies)]


def _sk_region_bytes_ops(part, m, n, k, a_bytes, b_bytes, c_bytes, extra_bytes=0):
    """(bytes, operations) that the function of the fused Stream-K region,
    its C tiles = epilogue(A @ B), needs on its real data (rows < M, columns
    < N), for A, B and C elements of ``a_bytes``, ``b_bytes`` (0.5 for
    packed int4) and ``c_bytes``, and ``extra_bytes`` of dequant scales:
    each A row and B column the region touches read once, each C element
    written once, 2 operations per multiply-add. The split tiles' slot
    round trip and their fix-up additions are the kernel's own
    decomposition, not the function's, and are not counted."""
    cfg = part.cfg
    rows, cols, elems = set(), set(), 0
    for c in part.contributions:  # one per Stream-K tile
        tm, tn = part.tile_mn(c.tile)
        rows.add(tm)
        cols.add(tn)
        elems += (max(0, min(m, (tm + 1) * cfg.bm) - tm * cfg.bm)
                  * max(0, min(n, (tn + 1) * cfg.bn) - tn * cfg.bn))
    a_rows = sum(max(0, min(m, (t + 1) * cfg.bm) - t * cfg.bm) for t in rows)
    b_cols = sum(max(0, min(n, (t + 1) * cfg.bn) - t * cfg.bn) for t in cols)
    read = (a_rows * a_bytes + b_cols * b_bytes) * k
    return read + elems * c_bytes + extra_bytes, 2 * elems * k


def bound_ms(nbytes, ops, peak=PEAK_BF16):
    t_bytes, t_ops = nbytes / HBM_BW, ops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_kernels(gen):
    """Each kernel at a decode shape (M = 4 slots) where the H100 selector
    uses it: B1 at mlp.gate (4, 14336, 4096, DP), B2 (with B3 fused in) at
    mlp.out (4, 4096, 14336, ALL_SK); then each again, beside its plain
    version, at the sweep shape (64, 4096, 4096)."""
    import torch

    from repro_torch.core.gemm import dtype_name
    from repro_torch.core.op import GemmOp
    from repro_torch.core.policies import ALL_SK
    from repro_torch.core.selector import default_selector
    from repro_torch.core.workpart import GemmShape, partition
    from repro_torch.kernels.dp.dp_gemm import dp_gemm_region, dp_gemm_region_plain
    from repro_torch.kernels.streamk import ops as sk_ops
    from repro_torch.kernels.streamk.streamk_gemm import (
        streamk_fixup_plain, streamk_phase1_plain, streamk_region,
    )

    def plain_region(a, b, part, c):
        return streamk_fixup_plain(streamk_phase1_plain(a, b, part), part, c)

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

    # B2 with B3 fused in -------------------------------------------------------
    m, n, k = 4, 4096, 14336
    a, b, _, _ = _operands(m, n, k, torch.bfloat16, gen)
    s = sel.select_op(GemmOp.plain(m, n, k, in_dtype=dtype_name(a.dtype)))
    part = partition(GemmShape(m, n, k), s.cfg, s.g, s.policy)
    if not part.sk_tiles or part.dp_tiles:
        raise AssertionError(f"expected an ALL_SK pick at {m}x{n}x{k}, got {s.policy.name}")
    c = torch.empty(m, n, dtype=a.dtype, device="cuda")
    c_p = torch.empty_like(c)
    c_k, p_k = streamk_region(a, b, part, c, workspace=True)
    used = _used_slots(p_k, part)
    p_p = streamk_phase1_plain(a, b, part)
    err2 = max(close(torch.where(used, p_k, 0.0), torch.where(used, p_p, 0.0), 2e-2,
                     "B2 timing, split-tile slots"),
               close(c_k, streamk_fixup_plain(p_p, part, c_p), 2e-2, "B2+B3 timing"))
    bs = _rotating(b)
    ms2, ev2 = time_ms(lambda: streamk_region(a, bs[next(it) % len(bs)], part, c))
    # one call: the plain sweep issues hundreds of small launches per call
    plain2, plain_ev2 = time_ms(lambda: plain_region(a, bs[next(it) % len(bs)], part, c_p),
                                iters=1)
    bnd2, by2 = bound_ms(*_sk_region_bytes_ops(part, m, n, k, 2, 2, 2))
    # under ALL_SK the region is the whole GEMM: torch.matmul computes it
    lib2, lib2_ev = time_ms(lambda: torch.matmul(a, bs[next(it) % len(bs)]))
    composed, composed_ev = time_ms(
        lambda: sk_ops.gemm(a, bs[next(it) % len(bs)], policy=ALL_SK, cfg=s.cfg, g=s.g))
    out["streamk_phase1"] = dict(
        shape=[m, n, k], policy=s.policy.name, tile=s.cfg.name, g=s.g, max_abs_err=err2,
        ms=ms2, plain_ms=plain2, bound_ms=bnd2, bound_by=by2, library_ms=lib2, event_ms=ev2,
        plain_event_ms=plain_ev2, library_event_ms=lib2_ev,
        library_of="torch.matmul of the whole GEMM (the ALL_SK region computes it)",
        composed_ms=composed, composed_event_ms=composed_ev)

    # each kernel beside its plain version at the sweep shape (device ms)
    m, n, k = SWEEP_SHAPES[0]
    a, b, _, _ = _operands(m, n, k, torch.bfloat16, gen)
    bs = _rotating(b)
    cfg = sel.select_op(GemmOp.plain(m, n, k, in_dtype=dtype_name(a.dtype))).cfg
    part = partition(GemmShape(m, n, k), cfg, 132, ALL_SK)
    c = torch.empty(m, n, dtype=a.dtype, device="cuda")
    c_p = torch.empty_like(c)
    pairs = {
        "dp_gemm_region": (lambda: dp_gemm_region(a, bs[next(it) % len(bs)], cfg, c=c, g=132),
                           lambda: dp_gemm_region_plain(a, bs[next(it) % len(bs)], cfg, c_p)),
        "streamk_phase1": (lambda: streamk_region(a, bs[next(it) % len(bs)], part, c),
                           lambda: plain_region(a, bs[next(it) % len(bs)], part, c_p)),
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


#: B5's device ms on the SIMT mainloop, before the bf16-activation rungs moved to
#: csrc/mma_bf16.cuh, as this script timed them on an NVIDIA H100 80GB HBM3 at 700 W, by
#: (kernel, pair): B5a at 64x16x1024x2048 (ALL_SK 16x128x128, g 132), B5b at
#: 64x4x1024x2048 (DP 8x256x128, g 132)
B5_SIMT_MS = {
    ("grouped_streamk_sk", "bf16"): 0.3070, ("grouped_streamk_sk", "int8"): 0.3687,
    ("grouped_streamk_sk", "int4"): 0.3436, ("grouped_streamk_dp", "bf16"): 0.2304,
    ("grouped_streamk_dp", "int8"): 0.3551, ("grouped_streamk_dp", "int4"): 0.2700,
}
B5_TABLE_SHAPES = {"grouped_streamk_sk": [64, 16, 1024, 2048],
                   "grouped_streamk_dp": [64, 4, 1024, 2048]}


def b5_table(grouped_rows, quant_rows):
    """Log B5's bf16-activation rungs in both forms at the kernel table's
    shapes: this run's device ms beside the SIMT mainloop's (``B5_SIMT_MS``),
    the bound and ``torch.bmm``; returns the rows."""
    import torch

    from repro_torch.kernels.common import mainloop

    rows = []
    log("B5, bf16 activations (device ms; the SIMT mainloop's in brackets), bound, torch.bmm:")
    log("| kernel | shape | bf16 | bf16 x int8 | bf16 x int4 | bound (bf16 / int8 / int4) | "
        "torch.bmm | mainloop |")
    for name, shape in B5_TABLE_SHAPES.items():
        dense = next(r for r in grouped_rows if r["shape"] == shape)
        ms = {"bf16": dense["ms"] if dense["kernel"] == name else dense["other_ms"]}
        bound = {"bf16": dense["bound_ms"]}
        for rung in ("int8", "int4"):
            row = next(r for r in quant_rows if r["kernel"] == name and r["rung"] == rung
                       and r["shape"] == shape)
            ms[rung], bound[rung] = row["ms"], row["bound_ms"]
        cells = " | ".join(f"{ms[p]:.4f} ({B5_SIMT_MS[name, p]:.4f})" for p in ms)
        log(f"| {'B5a' if name.endswith('sk') else 'B5b'} {name} | {'x'.join(map(str, shape))} "
            f"| {cells} | {' / '.join(f'{bound[p]:.4f}' for p in bound)} | "
            f"{dense['library_ms']:.4f} | {mainloop(name, torch.bfloat16)} |")
        rows.append(dict(kernel=name, shape=shape, ms=ms, simt_ms={
            p: B5_SIMT_MS[name, p] for p in ms}, bound_ms=bound,
            library_ms=dense["library_ms"], mainloop=mainloop(name, torch.bfloat16)))
    return rows


#: B5's device ms on its int8-activation rungs on the SIMT mainloop, before they moved to
#: csrc/mma_s8.cuh, as this script timed them on an NVIDIA H100 80GB HBM3 at 700 W (the kernel
#: table of PERF.md), by (kernel, rung), at the shapes of B5_TABLE_SHAPES: int8-dynamic is
#: int8 x int8, int4-dynamic int8 x packed int4
B5_S8_SIMT_MS = {
    ("grouped_streamk_sk", "int8-dynamic"): 0.31291,
    ("grouped_streamk_sk", "int4-dynamic"): 0.32485,
    ("grouped_streamk_dp", "int8-dynamic"): 0.26808,
    ("grouped_streamk_dp", "int4-dynamic"): 0.29148,
}


def b5_s8_table(quant_rows):
    """Log B5's int8-activation rungs (int8-dynamic and int4-dynamic) in
    both forms at the kernel table's shapes: this run's device ms beside the
    SIMT mainloop's (``B5_S8_SIMT_MS``), the bound and ``torch.bmm`` on the
    dequantized bf16 weight; returns the rows."""
    import torch

    from repro_torch.kernels.common import mainloop

    rows = []
    log("B5, int8 activations (device ms; the SIMT mainloop's in brackets), bound, torch.bmm:")
    log("| kernel | shape | int8-dynamic | int4-dynamic | bound (int8-dyn / int4-dyn) | "
        "torch.bmm (int8-dyn / int4-dyn) | mainloop |")
    for name, shape in B5_TABLE_SHAPES.items():
        ms, bound, lib = {}, {}, {}
        for rung in ("int8-dynamic", "int4-dynamic"):
            row = next(r for r in quant_rows if r["kernel"] == name and r["rung"] == rung
                       and r["shape"] == shape)
            ms[rung], bound[rung], lib[rung] = row["ms"], row["bound_ms"], row["library_ms"]
        cells = " | ".join(f"{ms[p]:.5f} ({B5_S8_SIMT_MS[name, p]:.5f})" for p in ms)
        log(f"| {'B5a' if name.endswith('sk') else 'B5b'} {name} | {'x'.join(map(str, shape))} "
            f"| {cells} | {' / '.join(f'{bound[p]:.5f}' for p in bound)} | "
            f"{' / '.join(f'{lib[p]:.4f}' for p in lib)} | {mainloop(name, torch.int8)} |")
        rows.append(dict(kernel=name, shape=shape, ms=ms, simt_ms={
            p: B5_S8_SIMT_MS[name, p] for p in ms}, bound_ms=bound, library_ms=lib,
            mainloop=mainloop(name, torch.int8)))
    return rows


#: B1's and B2+B3's device ms on the SIMT mainloop, before the bf16-activation rungs moved to
#: csrc/mma_bf16.cuh, as this script timed them on an NVIDIA H100 80GB HBM3 at 700 W (the
#: kernel table of PERF.md), by (kernel, pair): B1 at 4x14336x4096 (DP 8x128x128, g 132); B2+B3
#: at 4x4096x14336 (ALL_SK 8x256x128, g 132), for bf16 the composed call, for int8 and int4
#: B2's and B3's times added (their composed calls were not recorded)
B12_SIMT_MS = {
    ("dp_gemm_region", "bf16"): 0.11404, ("dp_gemm_region", "int8"): 0.17706,
    ("dp_gemm_region", "int4"): 0.13379, ("streamk_phase1", "bf16"): 0.1160,
    ("streamk_phase1", "int8"): 0.17522, ("streamk_phase1", "int4"): 0.11983,
}


def b12_table(timed, quant_rows):
    """Log B1 and the B2+B3 composition (one launch: B3 is fused into B2)
    on the bf16-activation rungs at the decode shapes of the kernel table:
    this run's device ms beside the SIMT mainloop's (``B12_SIMT_MS``), the
    bound and the library call; returns the rows."""
    import torch

    from repro_torch.kernels.common import mainloop

    rows = []
    log("B1 and B2+B3, bf16 activations at M = 4 (device ms; the SIMT mainloop's in "
        "brackets), bound, library:")
    log("| kernel | shape | bf16 | bf16 x int8 | bf16 x int4 | bound (bf16 / int8 / int4) | "
        "library (bf16 / int8 / int4) | mainloop |")
    for name in ("dp_gemm_region", "streamk_phase1"):
        dense = timed[name]
        rung_rows = {rung: next(r for r in quant_rows if r["kernel"] == name
                                and r["rung"] == rung and r["shape"][0] == N_SLOTS)
                     for rung in ("int8", "int4")}
        bound = {"bf16": dense["bound_ms"],
                 **{r: row["bound_ms"] for r, row in rung_rows.items()}}
        if name == "dp_gemm_region":
            ms = {"bf16": dense["ms"], **{r: row["ms"] for r, row in rung_rows.items()}}
            label = "B1 dp_gemm_region"
        else:
            ms = {"bf16": dense["composed_ms"],
                  **{r: row["composed_ms"] for r, row in rung_rows.items()}}
            label = "B2+B3 streamk_phase1 (B3 fused)"
        lib = {"bf16": dense["library_ms"],
               **{r: row["library_ms"] for r, row in rung_rows.items()}}
        cells = " | ".join(f"{ms[p]:.4f} ({B12_SIMT_MS[name, p]:.4f})" for p in ms)
        log(f"| {label} | {'x'.join(map(str, dense['shape']))} | {cells} | "
            f"{' / '.join(f'{bound[p]:.4f}' for p in bound)} | "
            f"{' / '.join(f'{lib[p]:.4f}' for p in lib)} | {mainloop(name, torch.bfloat16)} |")
        rows.append(dict(kernel=label, shape=dense["shape"], ms=ms,
                         simt_ms={p: B12_SIMT_MS[name, p] for p in ms}, bound_ms=bound,
                         library_ms=lib, mainloop=mainloop(name, torch.bfloat16)))
    return rows


#: B1's and B2+B3's device ms on their int8-activation rungs on the SIMT mainloop, before they
#: moved to csrc/mma_s8.cuh, as this script timed them on an NVIDIA H100 80GB HBM3 at 700 W
#: (the kernel table of PERF.md), by (kernel, rung), at B12_SIMT_MS's shapes: int8-dynamic is
#: int8 x int8, int4-dynamic int8 x packed int4; for B2+B3 B2's and B3's times added, as
#: B12_SIMT_MS has them
B12_S8_SIMT_MS = {
    ("dp_gemm_region", "int8-dynamic"): 0.11290,
    ("dp_gemm_region", "int4-dynamic"): 0.14803,
    ("streamk_phase1", "int8-dynamic"): 0.11550 + 0.00748,
    ("streamk_phase1", "int4-dynamic"): 0.11401 + 0.00748,
}


def b12_s8_table(quant_rows):
    """Log B1 and the B2+B3 composition (one launch: B3 is fused into B2)
    on the int8-activation rungs (int8-dynamic and int4-dynamic) at the
    decode shapes of the kernel table: this run's device ms beside the SIMT
    mainloop's (``B12_S8_SIMT_MS``), the bound, the rung's
    library yardstick (``torch._int_mm`` for int8-dynamic, ``torch.matmul``
    on the dequantized bf16 weight for int4-dynamic) and ``torch.matmul`` on
    the dequantized bf16 weight for both (the int8 rung's yardstick, timed
    at the same shape); returns the rows."""
    import torch

    from repro_torch.kernels.common import mainloop

    rungs = ("int8-dynamic", "int4-dynamic")
    rows = []
    log("B1 and B2+B3, int8 activations at M = 4 (device ms; the SIMT mainloop's in "
        "brackets), bound, library:")
    log("| kernel | shape | int8-dynamic | int4-dynamic | bound (int8-dyn / int4-dyn) | "
        "library (int8-dyn / int4-dyn) | torch.matmul, dequantized | mainloop |")

    def decode_row(name, rung):
        return next(r for r in quant_rows if r["kernel"] == name and r["rung"] == rung
                    and r["shape"][0] == N_SLOTS)

    for name in ("dp_gemm_region", "streamk_phase1"):
        own = {rung: decode_row(name, rung) for rung in rungs}
        bound = {r: row["bound_ms"] for r, row in own.items()}
        if name == "dp_gemm_region":
            ms = {r: row["ms"] for r, row in own.items()}
            label = "B1 dp_gemm_region"
        else:
            ms = {r: row["composed_ms"] for r, row in own.items()}
            label = "B2+B3 streamk_phase1 (B3 fused)"
        lib = {r: row["library_ms"] for r, row in own.items()}
        dense_lib = decode_row(name, "int8")["library_ms"]
        shape = own[rungs[0]]["shape"]
        cells = " | ".join(f"{ms[p]:.5f} ({B12_S8_SIMT_MS[name, p]:.5f})" for p in ms)
        log(f"| {label} | {'x'.join(map(str, shape))} | {cells} | "
            f"{' / '.join(f'{bound[p]:.5f}' for p in bound)} | "
            f"{' / '.join(f'{lib[p]:.4f}' for p in lib)} | {dense_lib:.4f} | "
            f"{mainloop(name, torch.int8)} |")
        rows.append(dict(kernel=label, shape=shape, ms=ms,
                         simt_ms={p: B12_S8_SIMT_MS[name, p] for p in ms}, bound_ms=bound,
                         library_ms=lib, dequantized_matmul_ms=dense_lib,
                         mainloop=mainloop(name, torch.int8)))
    return rows


#: the f32 table's GEMMs: (label, kernel, shape, policy name, tile) at g = 132, the kernel
#: table's decode shapes; and olmoe-1b-7b's router (4 x 2048 -> 64), the f32 GEMM that
#: every olmoe rung serves, under the H100 selector's pick (policy None)
F32_TABLE = (("B1", "dp_gemm_region", (4, 14336, 4096), "dp", (8, 128, 128)),
             ("B2+B3", "streamk_phase1", (4, 4096, 14336), "all_sk", (8, 256, 128)),
             ("B2+B3 router", "streamk_phase1", (4, 64, 2048), None, None),
             ("B5a", "grouped_streamk_sk", (64, 16, 1024, 2048), "all_sk", (16, 128, 128)),
             ("B5b", "grouped_streamk_dp", (64, 4, 1024, 2048), "dp", (8, 256, 128)))
#: the f32-activation pairs of the f32 table, as (pair, weight bits or None for f32): the
#: router is timed on f32 alone, the GEMM every olmoe rung serves
F32_PAIRS = (("f32", None), ("f32*int8", 8), ("f32*int4", 4))


def f32_table(gen):
    """B1, the B2+B3 composition (one launch) and both B5 forms on f32
    activations, with f32, int8 and packed int4 weights (the f32 FMA
    mainloop of ``csrc/fma_f32.cuh``) at
    ``F32_TABLE``'s shapes: device ms beside ``torch.matmul`` or
    ``torch.bmm`` in f32 (TF32 off; on the dequantized weight for the
    quantized pairs) and the bound (bytes over 3.35 TB/s or operations over
    67 TFLOP/s: A and C in f32, B at 4, 1 or 0.5 bytes a weight plus its f32
    scales; B2+B3: the split tiles' partials written and read back too),
    each call first held against that library call at the f32 tolerance,
    1e-4, and B1's and B2's also against their plain versions
    (``dp_gemm_region_plain``; ``streamk_phase1_plain`` on the split tiles'
    contributor slots) at 1e-4; each row's plain version (B2+B3:
    ``streamk_phase1_plain`` then ``streamk_fixup_plain``; B5:
    ``gemm_grouped_streamk_plain``) timed beside it; returns the rows."""
    import torch

    from repro_torch.core.op import GemmOp
    from repro_torch.core.policies import ALL_POLICIES, TileConfig
    from repro_torch.core.quant import quantize_weight
    from repro_torch.core.selector import default_selector
    from repro_torch.core.workpart import GemmShape, partition
    from repro_torch.kernels.common import mainloop
    from repro_torch.kernels.dp.dp_gemm import dp_gemm_region, dp_gemm_region_plain
    from repro_torch.kernels.streamk import ops as sk_ops
    from repro_torch.kernels.streamk.grouped import (
        gemm_grouped_streamk,
        gemm_grouped_streamk_plain,
    )
    from repro_torch.kernels.streamk.streamk_gemm import (
        streamk_fixup_plain,
        streamk_phase1_plain,
        streamk_region,
    )

    policies = {p.name: p for p in ALL_POLICIES}
    rows = []
    it = iter(range(10**9))
    log("B1, B2+B3 and B5, f32 activations (device ms), bound, torch.matmul / torch.bmm in f32 "
        "(quantized pairs: on the dequantized weight):")
    log("| kernel | pair | shape | policy / tile, g | ms | bound (by) | plain | library | "
        "mainloop |")
    for label, name, shape, pol, tile in F32_TABLE:
        *lead, m, n, k = shape
        if pol is None:
            s = default_selector("cuda").select_op(
                GemmOp.plain(m, n, k, in_dtype="float32", out_dtype="float32"))
            policy, cfg, grid = s.policy, s.cfg, s.g
        else:
            policy, cfg, grid = policies[pol], TileConfig(*tile), 132
        a = torch.randn(*lead, m, k, generator=gen, device="cuda")
        w = torch.randn(*lead, k, n, generator=gen, device="cuda") / math.sqrt(k)
        groups = lead[0] if lead else 1
        c = torch.empty(m, n, device="cuda") if name == "dp_gemm_region" else None
        library = torch.bmm if lead else torch.matmul
        for pair, bits in F32_PAIRS[:1] if pol is None else F32_PAIRS:
            if bits is None:
                b, w_lib, kw, b_bytes = w, w, {}, 4
            else:
                q = quantize_weight(w, bits=bits)
                b, w_lib = q.values, q.dequantize()
                kw, b_bytes = dict(scale=q.scales, b_bits=bits), bits / 8
            bs = _rotating(b)
            ws = _rotating(w_lib)

            def kernel(b, a=a, c=c, name=name, policy=policy, cfg=cfg, grid=grid, kw=kw):
                if name == "dp_gemm_region":
                    return dp_gemm_region(a, b, cfg, c=c, g=grid, **kw)
                if name == "streamk_phase1":
                    return sk_ops.gemm(a, b, policy=policy, cfg=cfg, g=grid,
                                       out_dtype=torch.float32, **kw)
                return gemm_grouped_streamk(a, b, policy=policy, cfg=cfg, g=grid,
                                            out_dtype=torch.float32, **kw)

            def plain(b=bs[0], a=a, name=name, cfg=cfg, kw=kw):
                if name == "dp_gemm_region":
                    return dp_gemm_region_plain(a, b, cfg, torch.empty(m, n, device="cuda"), **kw)
                if name == "streamk_phase1":  # the plain ALL_SK composition: B2, then B3
                    return streamk_fixup_plain(
                        streamk_phase1_plain(a, b, part, b_bits=kw.get("b_bits", 8)), part,
                        torch.empty(m, n, device="cuda"), scale=kw.get("scale"))
                return gemm_grouped_streamk_plain(a, b, sizes=(m,) * groups,
                                                  out_dtype=torch.float32, bk=cfg.bk, **kw)

            err = close(kernel(bs[0]), library(a, ws[0]), 1e-4, f"{label} {pair} f32 table")
            plain_err = None
            if name == "dp_gemm_region":
                plain_err = close(dp_gemm_region(a, bs[0], cfg, c=c, g=grid, **kw),
                                  dp_gemm_region_plain(a, bs[0], cfg, torch.empty_like(c), **kw),
                                  1e-4, f"{label} {pair} against its plain version")
            if name == "streamk_phase1":
                part = partition(GemmShape(m, n, k), cfg, grid, policy)
            if name == "streamk_phase1" and part.sk_tiles:
                b_bits = kw.get("b_bits", 8)
                _, partials = streamk_region(a, bs[0], part, torch.empty(m, n, device="cuda"),
                                             b_bits=b_bits, workspace=True)
                used = _used_slots(partials, part)[:, :, 0, 0]
                plain_err = close(partials[used],
                                  streamk_phase1_plain(a, bs[0], part, b_bits=b_bits)[used],
                                  1e-4, f"{label} {pair} B2 against its plain version"
                                  ) if used.any() else 0.0
            if name == "streamk_phase1" and part.dp_tiles:
                raise AssertionError(f"{label}: the plain composition times ALL_SK alone, "
                                     f"not {policy.name}")
            ms = time_ms(lambda: kernel(bs[next(it) % len(bs)]))[0]
            lib = time_ms(lambda: library(a, ws[next(it) % len(ws)]))[0]
            plain_ms = time_ms(plain)[0]
            scale_bytes = 0 if bits is None else groups * n * 4
            if name == "streamk_phase1":
                bnd, by = bound_ms(*_sk_region_bytes_ops(part, m, n, k, 4, b_bytes, 4,
                                                         scale_bytes), PEAK_F32)
            else:
                bnd, by = bound_ms(groups * (m * k * 4 + k * n * b_bytes + m * n * 4)
                                   + scale_bytes, 2 * groups * m * n * k, PEAK_F32)
            log(f"| {label} {name} | {pair} | {'x'.join(map(str, shape))} | {policy.name} / "
                f"{cfg.name}, {grid} | {ms:.5f} | {bnd:.5f} ({by}) | {plain_ms:.4f} | {lib:.5f} | "
                f"{mainloop(name, torch.float32)} |")
            rows.append(dict(kernel=label, name=name, pair=pair, shape=list(shape),
                             policy=policy.name, tile=cfg.name, g=grid, max_abs_err=err,
                             plain_max_abs_err=plain_err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bnd, bound_by=by, library_ms=lib,
                             library_of=library.__name__ + ("" if bits is None
                                                            else " on the dequantized weight"),
                             mainloop=mainloop(name, torch.float32)))
            del bs, ws
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
# Phase 2c: the quantization ladder, B1, B2 (B3 fused) and B5 on int8 and int4 weights
# ---------------------------------------------------------------------------


def _quant_operands(m, n, k, pair, gen, lead=()):
    """One operand pair of the ladder on the card: (a, b values, quantized
    kwargs, a_ref, w_ref, out dtype, tol). The weight is quantized per
    output channel (``quantize_weight``); int8 activations per row with
    their scales. ``a_ref @ w_ref`` is the dequantize-then-matmul reference
    in f32."""
    import torch

    from repro_torch.core.quant import quantize_activations, quantize_weight

    _, act, bits, act_q, tol = pair
    a = torch.randn(*lead, m, k, generator=gen, device="cuda").to(getattr(torch, act))
    q = quantize_weight(torch.randn(*lead, k, n, generator=gen, device="cuda") / math.sqrt(k),
                        bits=bits)
    kw = dict(scale=q.scales, b_bits=bits)
    a_ref = a.float()
    if act_q:
        a, kw["scale_a"] = quantize_activations(a)
        a_ref = a.float() * kw["scale_a"][..., None]
    return a, q.values, kw, a_ref, q.dequantize(), getattr(torch, act), tol


#: the quantized sweep's shapes: the dense sweep's, and one with an odd K (int4's zero pad
#: nibble) whose rows are not 16-byte aligned
QUANT_SWEEP_SHAPES = SWEEP_SHAPES + ((13, 400, 331),)


def quant_sweep(gen):
    """B1 and the Stream-K region (B2 with B3 fused in) on every pair of the
    ladder: all policies x g in {66, 132, 264} x epilogues {none, mul_silu,
    bias+gelu} at each quantized sweep shape, through ``ops.gemm`` against
    dequantize-then-matmul, and at g 66 and 132 each kernel on its own
    against its plain version (the split tiles' partials and the region's C
    against the plain sweep and fix-up, B1's C). The Stream-K composition
    is bitwise deterministic on every pair."""
    import torch

    from repro_torch.core.gemm import dtype_name
    from repro_torch.core.op import Epilogue, GemmOp
    from repro_torch.core.policies import ALL_POLICIES, ALL_SK
    from repro_torch.core.selector import default_selector
    from repro_torch.core.workpart import GemmShape, partition
    from repro_torch.kernels.dp.dp_gemm import dp_gemm_region, dp_gemm_region_plain
    from repro_torch.kernels.streamk import ops
    from repro_torch.kernels.streamk.streamk_gemm import (
        streamk_fixup_plain, streamk_phase1_plain, streamk_region,
    )

    errs = {}
    sel = default_selector("cuda")
    cases = bitwise = 0
    for (m, n, k), pair in ((shape, pair) for shape in QUANT_SWEEP_SHAPES for pair in QUANT_PAIRS):
        a, b, qkw, a_ref, w_ref, out, tol = _quant_operands(m, n, k, pair, gen)
        bits = qkw["b_bits"]
        scales = {key: v for key, v in qkw.items() if key != "b_bits"}
        in_dtype = f"{dtype_name(a.dtype)}*int{bits}"
        cfg = sel.select_op(GemmOp.plain(m, n, k, in_dtype=in_dtype,
                                         out_dtype=dtype_name(out))).cfg
        ref_acc = a_ref @ w_ref
        bias = torch.randn(n, generator=gen, device="cuda").to(out)
        operand = torch.randn(m, n, generator=gen, device="cuda").to(out)
        for epi_name, epi, kw in (
            ("none", Epilogue(), {}),
            ("mul_silu", Epilogue(binary="mul_silu"), {"operand": operand}),
            ("bias+gelu", Epilogue(activation="gelu", bias=True), {"bias": bias}),
        ):
            want = epi.apply(ref_acc, **kw).to(out)
            for pol in ALL_POLICIES:
                for g in (66, 132, 264):
                    what = f"{m}x{n}x{k} {pair[0]} {pol.name} g={g} {cfg.name} {epi_name}"
                    part = partition(GemmShape(m, n, k), cfg, g, pol)
                    c = ops.gemm(a, b, policy=pol, cfg=cfg, g=g, out_dtype=out, epilogue=epi,
                                 **qkw, **kw)
                    key = f"gemm {pair[0]}"
                    errs[key] = max(errs.get(key, 0.0), close(c, want, tol, what))
                    cases += 1
                    if g == 264:  # the composition only: the kernels are held at 66 and 132
                        continue
                    c_k = torch.zeros(m, n, dtype=out, device="cuda")
                    c_p = torch.zeros(m, n, dtype=out, device="cuda")
                    if part.sk_tiles:
                        _, p_k = streamk_region(a, b, part, c_k, epilogue=epi, b_bits=bits,
                                                workspace=True, **scales, **kw)
                        p_p = streamk_phase1_plain(a, b, part, b_bits=bits)
                        used = _used_slots(p_k, part)
                        streamk_fixup_plain(p_p, part, c_p, epilogue=epi, **scales, **kw)
                        key = f"streamk_phase1 {pair[0]}"
                        errs[key] = max(
                            errs.get(key, 0.0),
                            close(torch.where(used, p_k, 0.0), torch.where(used, p_p, 0.0), tol,
                                  what + " B2 slots"),
                            close(c_k, c_p, tol, what + " B2+B3"))
                    if part.dp_tiles:
                        dp_gemm_region(a, b, cfg, c=c_k, tile_offset=part.sk_tiles, g=g,
                                       epilogue=epi, **qkw, **kw)
                        dp_gemm_region_plain(a, b, cfg, c_p, tile_offset=part.sk_tiles,
                                             epilogue=epi, **qkw, **kw)
                        key = f"dp_gemm_region {pair[0]}"
                        errs[key] = max(errs.get(key, 0.0), close(c_k, c_p, tol, what + " B1"))
        runs = [ops.gemm(a, b, policy=ALL_SK, cfg=cfg, g=132, out_dtype=out, **qkw)
                for _ in range(2)]
        if not torch.equal(runs[0], runs[1]):
            raise AssertionError(f"{m}x{n}x{k} {pair[0]}: B2+B3 not bitwise deterministic")
        bitwise += 1
    torch.cuda.synchronize()
    return errs, cases, bitwise


#: the quantized grouped sweep's shapes: olmoe-1b-7b's expert shapes, the small unaligned
#: one, and the same with an odd K
QUANT_GROUPED_SHAPES = GROUPED_SHAPES + (GROUPED_RAGGED, GROUPED_RAGGED[:3] + (201,))


def quant_sweep_grouped(gen):
    """B5 on every pair of the ladder: every policy x g in {66, 132, 264} x
    epilogues {none, gelu, bias, mul_silu} x group sizes {full, ragged with
    empty groups}, against the plain version and the per-group
    dequantize-then-matmul reference; rows past a group's size stay 0; the
    Stream-K form with split tiles is bitwise deterministic."""
    import torch

    from repro_torch.core.op import Epilogue
    from repro_torch.core.policies import ALL_POLICIES, ALL_SK
    from repro_torch.kernels.streamk.grouped import (
        gemm_grouped_streamk, gemm_grouped_streamk_plain,
    )

    errs = {}
    cases = bitwise = 0
    rng = np.random.default_rng(2)
    for (gc, m, n, k), pair in ((shape, pair) for shape in QUANT_GROUPED_SHAPES
                                for pair in QUANT_PAIRS):
        a, b, qkw, a_ref, w_ref, out, tol = _quant_operands(m, n, k, pair, gen, lead=(gc,))
        cfg = grouped_pick(gc, m, n, k, out).cfg
        bias = torch.randn(gc, n, generator=gen, device="cuda").to(out)
        operand = torch.randn(gc, m, n, generator=gen, device="cuda").to(out)
        ragged = (0, m) + tuple(int(s) for s in rng.integers(0, m + 1, size=gc - 2))
        for sizes in ((m,) * gc, ragged):
            dead = (torch.arange(m, device="cuda")[None, :]
                    >= torch.tensor(sizes, device="cuda")[:, None])[:, :, None]
            for epi, kw in ((Epilogue(), {}), (Epilogue(activation="gelu"), {}),
                            (Epilogue(bias=True), {"bias": bias}),
                            (Epilogue(binary="mul_silu"), {"operand": operand})):
                what = f"B5 {gc}x{m}x{n}x{k} {pair[0]} {cfg.name} {epi.name} sizes={sizes}"
                want = gemm_grouped_streamk_plain(a, b, sizes=sizes, out_dtype=out,
                                                  epilogue=epi, bk=cfg.bk, **qkw, **kw)
                ref = torch.zeros_like(want)
                for i, s in enumerate(sizes):
                    if s:
                        ref[i, :s] = epi.apply(
                            a_ref[i, :s] @ w_ref[i],
                            bias=None if "bias" not in kw else bias[i],
                            operand=None if "operand" not in kw else operand[i, :s],
                        ).to(out)
                close(want, ref, tol, what + " plain vs dequantize-then-matmul")
                for pol in ALL_POLICIES:
                    for g in (66, 132, 264):
                        got = gemm_grouped_streamk(a, b, policy=pol, cfg=cfg, g=g, out_dtype=out,
                                                   epilogue=epi, group_sizes=sizes, **qkw, **kw)
                        key = f"{_grouped_kernel_name(pol)} {pair[0]}"
                        label = f"{what} {pol.name} g={g}"
                        errs[key] = max(errs.get(key, 0.0), close(got, want, tol, label),
                                        close(got, ref, tol, label + " vs dequantize"))
                        if torch.where(dead, got, 0).abs().max().item() != 0:
                            raise AssertionError(f"{label}: rows past a group's size are not 0")
                        cases += 1
            for g in (66, 132, 264):
                if _splits_tiles(sizes, n, k, cfg, g):
                    c1, c2 = (gemm_grouped_streamk(a, b, policy=ALL_SK, cfg=cfg, g=g,
                                                   out_dtype=out, group_sizes=sizes, **qkw)
                              for _ in range(2))
                    if not torch.equal(c1, c2):
                        raise AssertionError(f"B5 {gc}x{m}x{n}x{k} {pair[0]} g={g}: the "
                                             "Stream-K form is not bitwise deterministic")
                    bitwise += 1
    torch.cuda.synchronize()
    if not bitwise:
        raise AssertionError("no quantized B5 case split a tile: the hand-off went untested")
    return errs, cases, bitwise


def _int_mm_yardstick(a, b):
    """``torch._int_mm`` for an int8 x int8 product, where its shape rules
    allow: (call, label). It takes more than 16 rows, so a decode M is
    padded to the smallest size it accepts; None when none does."""
    import torch

    m, k = a.shape
    tried = []
    for mp in sorted({max(m, 17), 24, 32, 64}):
        if mp < m:
            continue
        a_p = torch.zeros(mp, k, dtype=torch.int8, device=a.device)
        a_p[:m] = a
        for b_lay, lay in ((b, "row-major B"), (b.t().contiguous().t(), "column-major B")):
            try:
                torch._int_mm(a_p, b_lay)
            except RuntimeError as e:
                tried.append(f"M={mp} {lay}: {str(e).splitlines()[0][:120]}")
                continue
            pad = f", M padded {m} -> {mp}" if mp != m else ""
            return (lambda a_p=a_p, b_lay=b_lay: torch._int_mm(a_p, b_lay),
                    f"torch._int_mm ({lay}{pad})")
    log(f"  torch._int_mm refused every shape tried: {tried}")
    return None, None


def _quant_bound(m, n, k, gc, a_bytes, b_bytes, act_q, peak):
    """(bound ms, by) of one quantized GEMM (gc groups): each input read
    once (A, B at its width, the f32 scales), C written once in bf16."""
    nbytes = gc * (m * k * a_bytes + k * n * b_bytes + n * 4 + (m * 4 if act_q else 0)
                   + m * n * 2)
    return bound_ms(nbytes, 2 * gc * m * n * k, peak)


def time_quant(gen):
    """Each rung's kernels (the served rungs and int4-dynamic, int8 x int4)
    at the decode (M = 4) and prompt (M = 57) shapes of the served runs: B1
    at mlp.gate (N 14336, K 4096), B2 (with B3 fused in) at mlp.out (N
    4096, K 14336) and B5 at olmoe-1b-7b's expert shapes; device and event
    ms beside the
    plain version, the bound (the int8 and int4 widths of B) and a library
    yardstick: ``torch._int_mm`` for int8 x int8 B1 and B2, else
    ``torch.matmul``/``torch.bmm`` on the dequantized bf16 weight, a dense
    yardstick that reads 2 bytes per weight."""
    import torch

    from repro_torch.core.gemm import dtype_name
    from repro_torch.core.op import GemmOp
    from repro_torch.core.policies import ALL_SK, DP, PolicyKind
    from repro_torch.core.quant import quantize_activations, quantize_weight
    from repro_torch.core.selector import default_selector
    from repro_torch.core.workpart import GemmShape, partition
    from repro_torch.kernels.dp.dp_gemm import dp_gemm_region, dp_gemm_region_plain
    from repro_torch.kernels.streamk import ops as sk_ops
    from repro_torch.kernels.streamk.grouped import (
        gemm_grouped_streamk, gemm_grouped_streamk_plain,
    )
    from repro_torch.kernels.streamk.streamk_gemm import (
        streamk_fixup_plain, streamk_phase1_plain, streamk_region,
    )

    sel = default_selector("cuda")
    rows = []
    it = iter(range(10**9))
    for rung, (bits, act_bits, _) in TIMED_RUNGS.items():
        act_q = act_bits == 8
        a_bytes, b_bytes = (1 if act_q else 2), (0.5 if bits == 4 else 1)
        peak = PEAK_INT8 if act_q else PEAK_BF16
        in_dtype = f"{'int8' if act_q else 'bfloat16'}*int{bits}"

        def operands(m, n, k, lead=()):
            a = torch.randn(*lead, m, k, generator=gen, device="cuda").to(torch.bfloat16)
            q = quantize_weight(torch.randn(*lead, k, n, generator=gen, device="cuda")
                                / math.sqrt(k), bits=bits)
            kw = dict(scale=q.scales, b_bits=bits)
            a_dense = a
            if act_q:
                a, kw["scale_a"] = quantize_activations(a)
            return a, a_dense, q, kw

        def timed(name, shape, policy, cfg, g, kernel, plain, err, bnd, by, lib, lib_label,
                  plain_iters=3):
            ms, ev = time_ms(kernel)
            plain_ms, plain_ev = time_ms(plain, iters=plain_iters)
            lib_ms, lib_ev = time_ms(lib) if lib is not None else (None, None)
            rows.append(dict(kernel=name, rung=rung, shape=list(shape), policy=policy,
                             tile=cfg.name, g=g, max_abs_err=err, ms=ms, event_ms=ev,
                             plain_ms=plain_ms, plain_event_ms=plain_ev, bound_ms=bnd,
                             bound_by=by, library_ms=lib_ms, library_event_ms=lib_ev,
                             library_of=lib_label))
            log(f"  {name}[{rung}] {'x'.join(map(str, shape))} {policy}/{cfg.name} g={g}: "
                f"device {ms:.4f} ms, events {ev:.4f} ms; plain {plain_ms:.4f} ms; "
                f"{lib_label} {lib_ms if lib_ms is None else round(lib_ms, 5)} ms; "
                f"bound {bnd:.5f} ms by {by}")

        for m in (4, 57):
            # B1 at mlp.gate ------------------------------------------------------
            n, k = 14336, 4096
            a, a_dense, q, kw = operands(m, n, k)
            s = sel.select_op(GemmOp.plain(m, n, k, in_dtype=in_dtype, out_dtype="bfloat16"))
            pol = "dp" if s.policy.kind == PolicyKind.DP else f"dp (pick {s.policy.name})"
            c = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
            c_p = torch.empty_like(c)
            err = close(dp_gemm_region(a, q.values, s.cfg, c=c, g=s.g, **kw),
                        dp_gemm_region_plain(a, q.values, s.cfg, c_p, **kw), 2e-2,
                        f"B1[{rung}] timing")
            vs = _rotating(q.values)
            w_bf16 = q.dequantize(torch.bfloat16)
            if act_q and bits == 8:
                lib, label = _int_mm_yardstick(a, q.values)
            else:
                ws = _rotating(w_bf16)
                lib, label = (lambda: torch.matmul(a_dense, ws[next(it) % len(ws)]),
                              "torch.matmul on the dequantized bf16 weight (dense yardstick)")
            bnd, by = _quant_bound(m, n, k, 1, a_bytes, b_bytes, act_q, peak)
            timed("dp_gemm_region", (m, n, k), pol, s.cfg, s.g,
                  lambda: dp_gemm_region(a, vs[next(it) % len(vs)], s.cfg, c=c, g=s.g, **kw),
                  lambda: dp_gemm_region_plain(a, vs[next(it) % len(vs)], s.cfg, c_p, **kw),
                  err, bnd, by, lib, label)

            # B2 with B3 fused in, at mlp.out ---------------------------------------
            n, k = 4096, 14336
            a, a_dense, q, kw = operands(m, n, k)
            scales = {key: v for key, v in kw.items() if key != "b_bits"}
            s = sel.select_op(GemmOp.plain(m, n, k, in_dtype=in_dtype, out_dtype="bfloat16"))
            policy = s.policy if s.policy.is_streamk else ALL_SK
            part = partition(GemmShape(m, n, k), s.cfg, s.g, policy)
            if not part.sk_tiles:
                part, policy = partition(GemmShape(m, n, k), s.cfg, s.g, ALL_SK), ALL_SK
            pol = policy.name if policy == s.policy else f"{policy.name} (pick {s.policy.name})"
            c = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
            c_p = torch.empty_like(c)
            c_k, p_k = streamk_region(a, q.values, part, c, b_bits=bits, workspace=True,
                                      **scales)
            used = _used_slots(p_k, part)
            p_p = streamk_phase1_plain(a, q.values, part, b_bits=bits)
            err2 = max(close(torch.where(used, p_k, 0.0), torch.where(used, p_p, 0.0), 2e-2,
                             f"B2[{rung}] timing, split-tile slots"),
                       close(c_k, streamk_fixup_plain(p_p, part, c_p, **scales), 2e-2,
                             f"B2+B3[{rung}] timing"))
            vs = _rotating(q.values)
            if act_q and bits == 8:
                lib, label = _int_mm_yardstick(a, q.values)
                label = label and f"{label} of the whole GEMM (the ALL_SK region computes it)"
            else:
                ws = _rotating(q.dequantize(torch.bfloat16))
                lib, label = (lambda: torch.matmul(a_dense, ws[next(it) % len(ws)]),
                              "torch.matmul on the dequantized bf16 weight, the whole GEMM "
                              "(dense yardstick)")
            bnd, by = bound_ms(*_sk_region_bytes_ops(
                part, m, n, k, a_bytes, b_bytes, 2, n * 4 + (m * 4 if act_q else 0)), peak)
            timed("streamk_phase1", (m, n, k), pol, s.cfg, s.g,
                  lambda: streamk_region(a, vs[next(it) % len(vs)], part, c, b_bits=bits,
                                         **scales),
                  lambda: streamk_fixup_plain(streamk_phase1_plain(
                      a, vs[next(it) % len(vs)], part, b_bits=bits), part, c_p, **scales),
                  err2, bnd, by, lib, label, plain_iters=1)
            rows[-1]["composed_ms"] = time_ms(lambda: sk_ops.gemm(
                a, vs[next(it) % len(vs)], policy=policy, cfg=s.cfg, g=s.g,
                out_dtype=torch.bfloat16, **kw))[0]

        # B5 at olmoe-1b-7b's expert shapes, both forms -----------------------------
        for gc, m, n, k in GROUPED_SHAPES:
            a, a_dense, q, kw = operands(m, n, k, lead=(gc,))
            s = default_selector("cuda").select_op(GemmOp(
                m, n, k, g=gc, kind="grouped", in_dtype=in_dtype, out_dtype="bfloat16",
                fused=True))
            want = gemm_grouped_streamk_plain(a, q.values, sizes=(m,) * gc,
                                              out_dtype=torch.bfloat16, bk=s.cfg.bk, **kw)
            w_bf16 = q.dequantize(torch.bfloat16)
            bnd, by = _quant_bound(m, n, k, gc, a_bytes, b_bytes, act_q, peak)
            for form in (s.policy, ALL_SK if s.policy.kind == PolicyKind.DP else DP):
                err = close(gemm_grouped_streamk(a, q.values, policy=form, cfg=s.cfg, g=s.g,
                                                 out_dtype=torch.bfloat16, **kw), want, 2e-2,
                            f"B5[{rung}] timing {gc}x{m}x{n}x{k} {form.name}")
                pol = form.name if form == s.policy else f"{form.name} (pick {s.policy.name})"
                timed(_grouped_kernel_name(form), (gc, m, n, k), pol, s.cfg, s.g,
                      lambda form=form: gemm_grouped_streamk(
                          a, q.values, policy=form, cfg=s.cfg, g=s.g, out_dtype=torch.bfloat16,
                          **kw),
                      lambda: gemm_grouped_streamk_plain(a, q.values, sizes=(m,) * gc,
                                                         out_dtype=torch.bfloat16, bk=s.cfg.bk,
                                                         **kw),
                      err, bnd, by, lambda: torch.bmm(a_dense, w_bf16),
                      "torch.bmm on the dequantized bf16 weights (dense yardstick)",
                      plain_iters=1)
            del w_bf16
    return rows


def quant_entry(rows, name, rung):
    """The timing of ``name`` on ``rung`` for the kernels line: at the
    decode shape where the selector picks it (M = 4, or B5's first expert
    shape), else the first shape where it ran."""
    mine = [r for r in rows if r["kernel"] == name and r["rung"] == rung]
    picked = [r for r in mine if "pick" not in r["policy"]]
    return dict((picked or mine)[0])


# ---------------------------------------------------------------------------
# Phase 2d: B6, the split-K baseline; the baseline comparison; gemm_batched
# ---------------------------------------------------------------------------


#: B6's operand pairs: the dense ones, then the quantized sweep's (name, activation dtype,
#: weight bits or None, int8 activations, tolerance)
SPLITK_PAIRS = (("f32", "float32", None, False, 1e-4), ("bf16", "bfloat16", None, False, 2e-2),
                *QUANT_PAIRS)
#: B6's sweep shapes: the sweep shape, a ragged one whose rows are not 16-byte aligned, an odd
#: K (int4's zero pad nibble), and K = 200 below bk * s for s >= 2 (empty splits)
SPLITK_SHAPES = ((64, 4096, 4096), (17, 302, 520), (13, 400, 331), (9, 384, 200))
SPLITK_S = (1, 2, 4, 8)
SPLITK_G = (0, 66, 132, 264)


def _splitk_operands(m, n, k, pair, gen):
    """(a, b, quantized kwargs, a_ref @ w_ref in f32, out dtype, tol) of one B6 pair."""
    if pair[2] is None:
        import torch

        a, b, _, _ = _operands(m, n, k, getattr(torch, pair[1]), gen)
        return a, b, {}, a.float() @ b.float(), a.dtype, pair[4]
    a, b, qkw, a_ref, w_ref, out, tol = _quant_operands(m, n, k, pair, gen)
    return a, b, qkw, a_ref @ w_ref, out, tol


def splitk_sweep(gen):
    """B6 on every operand pair (dense f32 and bf16, the ladder's six) x s in
    {1, 2, 4, 8} x g in {0, 66, 132, 264} at each split-K shape: the
    partials against the plain version (empty splits must read 0), ``ops.gemm``
    (the sum over the splits, then the scales) against ``gemm_ref`` or
    dequantize-then-matmul; two runs bitwise identical per (shape, pair, s).
    A planted fault, a reduction that drops the last split, must read at
    least 3 times its limit. Also returns each pair's B6 launches."""
    import torch

    from repro_torch.core.gemm import dtype_name
    from repro_torch.core.op import GemmOp
    from repro_torch.core.selector import default_selector
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.kernels.splitk import ops as splitk_ops
    from repro_torch.kernels.splitk.splitk_gemm import (
        k_per_split, splitk_partials, splitk_partials_plain,
    )

    sel = default_selector("cuda")
    errs = {}
    cases = bitwise = empty = 0
    fault = None
    launches = dict.fromkeys((p[0] for p in SPLITK_PAIRS), 0)

    def b6_launches():
        return sum(v for key, v in LAUNCHES.items() if key.startswith("splitk_partials"))

    for (m, n, k), pair in ((shape, pair) for shape in SPLITK_SHAPES for pair in SPLITK_PAIRS):
        launches[pair[0]] -= b6_launches()
        a, b, qkw, ref_acc, out, tol = _splitk_operands(m, n, k, pair, gen)
        bits = qkw.get("b_bits", 8)
        in_dtype = f"{dtype_name(a.dtype)}*int{bits}" if qkw else dtype_name(a.dtype)
        cfg = sel.select_op(GemmOp.plain(m, n, k, in_dtype=in_dtype,
                                         out_dtype=dtype_name(out))).cfg
        want = ref_acc.to(out)
        for sp in SPLITK_S:
            plain = splitk_partials_plain(a, b, cfg, sp, b_bits=bits)
            first_empty = -(-k // (k_per_split(k, cfg.bk, sp) * cfg.bk))
            for g in SPLITK_G:
                what = f"B6 {m}x{n}x{k} {pair[0]} {cfg.name} s={sp} g={g}"
                parts = splitk_partials(a, b, cfg, sp, g=g, b_bits=bits)
                key = f"splitk_partials {pair[0]}"
                errs[key] = max(errs.get(key, 0.0), close(parts, plain, tol, what))
                if first_empty < sp:
                    if parts[first_empty:].any():
                        raise AssertionError(f"{what}: an empty split is not 0")
                    empty += 1
                c = splitk_ops.gemm(a, b, cfg=cfg, s=sp, g=g, out_dtype=out, **qkw)
                key = f"gemm {pair[0]}"
                errs[key] = max(errs.get(key, 0.0), close(c, want, tol, what + " ops.gemm"))
                cases += 1
            runs = [splitk_ops.gemm(a, b, cfg=cfg, s=sp, g=132, out_dtype=out, **qkw)
                    for _ in range(2)]
            if not torch.equal(runs[0], runs[1]):
                raise AssertionError(f"B6 {m}x{n}x{k} {pair[0]} s={sp}: not bitwise deterministic")
            bitwise += 1
        if fault is None and (m, n, k) == SPLITK_SHAPES[0] and pair[0] == "f32":
            # the planted fault: the reduction drops the last of 4 splits
            bad = splitk_partials(a, b, cfg, 4)[:-1].sum(dim=0)
            limit = tol * max(1.0, want.abs().max().item())
            fault = dict(max_abs_diff=(bad - want).abs().max().item(), limit=limit)
            if fault["max_abs_diff"] < 3 * limit:
                raise AssertionError(f"B6 planted fault reads {fault['max_abs_diff']:.4e}, under "
                                     f"3 x its limit {limit:.4e}")
        launches[pair[0]] += b6_launches()
    torch.cuda.synchronize()
    if not empty:
        raise AssertionError("no B6 case had an empty split")
    return errs, cases, bitwise, empty, fault, launches


#: split factors of the baseline comparison, and its prompt M: the first served prompt's
#: length, the prompt shape the quantized timings use too
COMPARE_S = (2, 4, 8)
PROMPT_M = 57


def baseline_comparison(gen):
    """The slice's main path: at granite-8b's five projection shapes, M = 4
    (decode) and 57 (the first served prompt), bf16, one GEMM each through
    the H100 selector's pick (the whole composition), ``dp.ops.gemm`` and
    ``splitk.ops.gemm`` at s in {2, 4, 8}, both with the pick's tile and one
    block per tile, checked against ``gemm_ref``. The launch counters are
    zeroed just before and read just after. Then each is timed (device ms,
    weights past L2) beside ``torch.matmul``. Returns (rows, launches)."""
    import torch

    from repro_torch.core.gemm import dtype_name
    from repro_torch.core.op import GemmOp
    from repro_torch.core.selector import default_selector
    from repro_torch.core.workpart import GemmShape, partition
    from repro_torch.kernels.common import LAUNCHES, reset_launch_counts
    from repro_torch.kernels.dp import ops as dp_ops
    from repro_torch.kernels.splitk import ops as splitk_ops
    from repro_torch.kernels.streamk import ops as sk_ops
    from repro_torch.kernels.streamk.ref import gemm_ref

    sel = default_selector("cuda")
    shapes = [(m, n, k) for m in (N_SLOTS, PROMPT_M) for n, k in SLICE_NK]
    cases = []
    for m, n, k in shapes:
        a, b, _, _ = _operands(m, n, k, torch.bfloat16, gen)
        s = sel.select_op(GemmOp.plain(m, n, k, in_dtype=dtype_name(a.dtype)))
        fns = {"pick": lambda a, b, s=s: sk_ops.gemm(a, b, policy=s.policy, cfg=s.cfg, g=s.g),
               "dp": lambda a, b, s=s: dp_ops.gemm(a, b, cfg=s.cfg)}
        for sp in COMPARE_S:
            fns[f"splitk_s{sp}"] = lambda a, b, s=s, sp=sp: splitk_ops.gemm(a, b, cfg=s.cfg, s=sp)
        cases.append((m, n, k, a, b, s, fns))
    torch.cuda.synchronize()
    reset_launch_counts()
    worst = 0.0
    for m, n, k, a, b, s, fns in cases:
        want = gemm_ref(a, b, torch.float32)
        for name, fn in fns.items():
            worst = max(worst, close(fn(a, b), want, 2e-2, f"compare {m}x{n}x{k} {name}"))
    torch.cuda.synchronize()
    launches = {name: n for name, n in LAUNCHES.items() if n}
    log(f"baseline comparison ({len(cases)} shapes): launches {launches}; max err {worst:.3e}")
    if launches.get("splitk_partials", 0) != len(cases) * len(COMPARE_S):
        raise AssertionError(f"expected {len(cases) * len(COMPARE_S)} B6 launches, got "
                             f"{launches.get('splitk_partials', 0)}")
    needed = {"dp_gemm_region"}  # the DP baseline
    for m, n, k, a, b, s, fns in cases:
        part = partition(GemmShape(m, n, k), s.cfg, s.g, s.policy)
        needed |= {"streamk_phase1"} if part.sk_tiles else set()
        needed |= {"dp_gemm_region"} if part.dp_tiles else set()
    missing = sorted(name for name in needed if not launches.get(name))
    if missing:
        raise AssertionError(f"the baseline comparison never launched {missing}")
    rows = []
    for m, n, k, a, b, s, fns in cases:
        bs = _rotating(b)
        it = iter(range(10**9))
        row = dict(shape=[m, n, k], policy=s.policy.name, tile=s.cfg.name, g=s.g)
        for name, fn in fns.items():
            row[f"{name}_ms"], row[f"{name}_event_ms"] = time_ms(
                lambda fn=fn: fn(a, bs[next(it) % len(bs)]))
        row["matmul_ms"], row["matmul_event_ms"] = time_ms(
            lambda: torch.matmul(a, bs[next(it) % len(bs)]))
        row["bound_ms"], row["bound_by"] = bound_ms((m * k + k * n + m * n) * 2, 2 * m * n * k)
        rows.append(row)
        log(f"  {m}x{n}x{k} pick {s.policy.name}/{s.cfg.name} g={s.g} {row['pick_ms']:.4f}, dp "
            f"{row['dp_ms']:.4f}, " + ", ".join(f"s={sp} {row[f'splitk_s{sp}_ms']:.4f}"
                                                for sp in COMPARE_S)
            + f", torch.matmul {row['matmul_ms']:.4f}, bound {row['bound_ms']:.4f} ms")
    return rows, launches, worst


def time_splitk(gen):
    """B6 at the decode shape 4x14336x4096 (mlp.gate), s = 4, the bf16
    pick's tile, one block per tile, on every operand pair: its partials
    against the plain version first (dequantized, times the scales the
    reduction applies after them: 2e-2 for bf16 activations, 1e-4 for f32
    and int8 ones; int8 activations bitwise), then device and event ms
    beside the plain version and a library call of the whole GEMM:
    ``torch.matmul`` in f32 for f32 activations (on the dequantized weight
    for the ladder's), else ``torch.matmul`` on the dequantized bf16 weight,
    and ``torch._int_mm`` too for int8 x int8. The bound reads A and B once
    at their widths (packed int4: K * N / 2 bytes) and writes the s * M * N
    f32 partials. Returns one row per pair."""
    import torch

    from repro_torch.core.gemm import dtype_name
    from repro_torch.core.op import GemmOp
    from repro_torch.core.selector import default_selector
    from repro_torch.kernels.common import mainloop, rung_of
    from repro_torch.kernels.splitk.splitk_gemm import splitk_partials, splitk_partials_plain

    m, n, k, sp = 4, 14336, 4096, 4
    cfg = default_selector("cuda").select_op(
        GemmOp.plain(m, n, k, in_dtype="bfloat16")).cfg
    rows = []
    it = iter(range(10**9))
    for pair in SPLITK_PAIRS:
        name, act, bits, act_q, tol = pair
        if bits is None:
            a, b, _, _ = _operands(m, n, k, getattr(torch, act), gen)
            a_lib, w_lib, dequant, b_bits = a, b, None, 8
        else:
            a, b, qkw, a_ref, w_ref, _, tol = _quant_operands(m, n, k, pair, gen)
            b_bits = bits
            dequant = qkw["scale"][None, :] * (qkw["scale_a"][:, None] if act_q else 1.0)
            lib_dtype = torch.float32 if act == "float32" and not act_q else torch.bfloat16
            a_lib, w_lib = a_ref.to(lib_dtype), w_ref.to(lib_dtype)
        what = f"B6 timing {m}x{n}x{k} {name} s={sp} {cfg.name}"
        got = splitk_partials(a, b, cfg, sp, b_bits=b_bits)
        want = splitk_partials_plain(a, b, cfg, sp, b_bits=b_bits)
        bitwise = bool(torch.equal(got, want))
        if act_q and not bitwise:
            raise AssertionError(f"{what}: int8-activation partials differ from the plain "
                                 f"version's bits")
        err = (close(got, want, tol, what) if dequant is None
               else close(got * dequant, want * dequant, tol, what))
        del got, want
        bs = _rotating(b)
        ms, ev = time_ms(lambda: splitk_partials(a, bs[next(it) % len(bs)], cfg, sp,
                                                 b_bits=b_bits))
        plain, plain_ev = time_ms(lambda: splitk_partials_plain(
            a, bs[next(it) % len(bs)], cfg, sp, b_bits=b_bits), iters=3 if act_q else 20)
        ws = _rotating(w_lib)
        lib, lib_ev = time_ms(lambda: torch.matmul(a_lib, ws[next(it) % len(ws)]))
        label = f"torch.matmul in {dtype_name(w_lib.dtype)} of the whole GEMM" + (
            "" if bits is None else " on the dequantized weight")
        row = dict(pair=name, rung=rung_of(a.dtype, b.dtype, b_bits),
                   mainloop=mainloop("splitk_partials", a.dtype), shape=[m, n, k],
                   policy=f"split-K s={sp}", tile=cfg.name, g=0, s=sp, max_abs_err=err,
                   bitwise=bitwise, ms=ms, event_ms=ev, plain_ms=plain, plain_event_ms=plain_ev,
                   library_ms=lib, library_event_ms=lib_ev, library_of=label)
        del ws
        if act_q and bits == 8:
            int_mm, int_label = _int_mm_yardstick(a, b)
            row["dense_library_ms"] = lib
            row["library_ms"], row["library_event_ms"] = (
                time_ms(int_mm) if int_mm is not None else (None, None))
            row["library_of"] = int_label and f"{int_label} of the whole GEMM"
        a_bytes = a.element_size()
        b_bytes = 0.5 if b_bits == 4 else b.element_size()
        peak = PEAK_INT8 if act_q else PEAK_F32 if act == "float32" else PEAK_BF16
        row["bound_ms"], row["bound_by"] = bound_ms(
            m * k * a_bytes + k * n * b_bytes + sp * m * n * 4, 2 * m * n * k, peak)
        rows.append(row)
        log(f"  B6 {m}x{n}x{k} s={sp} {cfg.name} {name} ({row['mainloop']}): device {ms:.5f} ms, "
            f"events {ev:.5f} ms; plain {plain:.4f} ms; {row['library_of']} "
            f"{row['library_ms'] if row['library_ms'] is None else round(row['library_ms'], 5)}"
            f" ms; bound {row['bound_ms']:.5f} ms by {row['bound_by']}; max err {err:.3e}"
            f"{', bitwise' if bitwise else ''}")
        del bs
    return rows


def batched_check(gen):
    """``gemm_batched`` through the ``cuda`` backend at B = 4, granite-8b's
    4096 -> 14336 at M = 4, f32, against ``torch.bmm``; the launches must be
    B times the pick's kernels (the loop form)."""
    import torch

    from repro_torch.core.gemm import gemm_batched, gemm_context
    from repro_torch.core.workpart import GemmShape, partition
    from repro_torch.kernels.common import count_launches

    nb, m, k, n = 4, N_SLOTS, 4096, 14336
    x = torch.randn(nb, m, k, generator=gen, device="cuda")
    w = torch.randn(nb, k, n, generator=gen, device="cuda") / math.sqrt(k)
    with count_launches() as launched, gemm_context(backend="cuda") as ctx:
        got = gemm_batched(x, w, tag="batched")
    torch.cuda.synchronize()
    [e] = ctx.log
    sel = e.selection
    part = partition(GemmShape(m, n, k), sel.cfg, sel.g, sel.policy)
    per = (["streamk_phase1"] if part.sk_tiles else []) + (
        ["dp_gemm_region"] if part.dp_tiles else [])
    if e.op.fused or e.op.kind != "batched" or len(e.op.key) != 7 or launched != per * nb:
        raise AssertionError(f"gemm_batched: key {e.op.key}, launches {launched}, expected "
                             f"{per} x {nb}")
    err = close(got, torch.bmm(x, w), 1e-4, "gemm_batched vs torch.bmm")
    log(f"gemm_batched {nb}x{m}x{n}x{k} f32: {sel.policy.name}/{sel.cfg.name} g={sel.g}, "
        f"launches {launched}, max err {err:.3e} against torch.bmm")
    return dict(shape=[nb, m, n, k], policy=sel.policy.name, tile=sel.cfg.name, g=sel.g,
                launches=launched, max_abs_err=err)


# ---------------------------------------------------------------------------
# Phase 3: serve granite-8b, then olmoe-1b-7b
# ---------------------------------------------------------------------------


#: the rung of a served op, by its input-dtype fingerprint (None: dense)
RUNG_OF = {"bfloat16*int8": "int8", "int8*int8": "int8-dynamic", "bfloat16*int4": "int4"}


def _kernels_of(entry):
    """The launch counters one logged selection calls for."""
    from repro_torch.core.workpart import GemmShape, partition
    from repro_torch.kernels.common import launch_name

    sel = entry.selection
    rung = RUNG_OF.get(entry.op.in_dtype)
    if entry.op.fused:
        return {launch_name(_grouped_kernel_name(sel.policy), rung)}
    part = partition(GemmShape(*entry.local_mnk), sel.cfg, sel.g, sel.policy)
    names = set()
    if part.sk_tiles:
        names.add(launch_name("streamk_phase1", rung))
    if part.dp_tiles:
        names.add(launch_name("dp_gemm_region", rung))
    return names


def _gemm_weight_bytes(params):
    """Bytes of every GEMM weight: the stacked projections, routers and
    experts (the norms are (L, D)) and lm_head; a quantized one counts its
    values and scales."""
    from repro_torch.core.quant import is_quantized

    def nbytes(t):
        return t.nbytes if is_quantized(t) else t.numel() * t.element_size()

    return sum(nbytes(t) for t in _leaves(params["layers"]) if t.dim() >= 3) + nbytes(
        params["lm_head"])


def phase_serve(arch, failures, then=None):
    """Serve ``arch`` at full width on the ``cuda`` backend: dense bf16, then
    on each rung of the quantization ladder, quantized from the same bf16
    weights (each quantized tree freed before the next). ``then(model,
    params, runs)``, when given, runs last, on the bf16 weights. Returns the
    runs' records by rung ("dense" first); see the module docstring."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM

    cfg = get_config(arch)
    model = LM(cfg)
    t0 = time.perf_counter()
    params = model.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"{arch} FULL: {n_params / 1e9:.3f} B parameters "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB on the card) in "
        f"{time.perf_counter() - t0:.1f}s")
    runs = {"dense": serve_run(arch, model, params, None, failures)}
    dense_logits = runs["dense"].pop("logits")
    for rung, (bits, act_bits, _) in RUNGS.items():
        t0 = time.perf_counter()
        qparams, n_quant, n_skipped = model.quantize_weights(params, bits=bits,
                                                             act_bits=act_bits)
        torch.cuda.synchronize()
        quant_s = time.perf_counter() - t0
        log(f"{arch} {rung}: quantized {n_quant} weight leaves ({n_skipped} skipped) in "
            f"{quant_s:.1f}s; {torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
        runs[rung] = serve_run(arch, model, qparams, rung, failures, dense_logits=dense_logits)
        runs[rung].update(quantize_s=quant_s, quantized_leaves=n_quant)
        runs[rung].pop("logits")
        del qparams
        gc.collect()
        torch.cuda.empty_cache()
    if then is not None:
        then(model, params, runs)
    return runs


def serve_run(arch, model, params, rung, failures, dense_logits=None):
    """One served run of ``model`` on ``params`` (dense when ``rung`` is
    None) with its checks: launch counts, logits against the ``torch``
    backend (a breach, dense or quantized, is appended to ``failures``, so
    every run reports before the script fails), a planted fault, timings
    and the decode breakdown."""
    import torch

    from repro_torch.core.gemm import gemm_context
    from repro_torch.kernels.common import LAUNCHES, count_launches, reset_launch_counts
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg = model.cfg
    label = arch if rung is None else f"{arch} [{rung}]"
    weight_bytes = _gemm_weight_bytes(params)
    n_slots, max_seq = N_SLOTS, MAX_SEQ
    engine = ServeEngine(model, params, ServeConfig(n_slots=n_slots, max_seq=max_seq, eos=-1),
                         backend="cuda")
    prompts = serve_prompts(cfg.vocab_size)
    for p in prompts:
        engine.submit(p, max_new_tokens=8)

    reset_launch_counts()
    done = engine.run()
    torch.cuda.synchronize()
    launches = {name: n for name, n in LAUNCHES.items() if n}

    if len(done) != 4 or engine.exhausted:
        raise AssertionError(f"{label}: served {len(done)}/4 requests")
    for r in done:
        if len(r.out_tokens) != 8 or not all(0 <= t < cfg.vocab_size for t in r.out_tokens):
            raise AssertionError(f"{label} request {r.uid}: bad tokens {r.out_tokens}")
    needed = set()
    for e in engine.selection_log:
        needed |= _kernels_of(e)
    fingerprints = sorted({e.op.in_dtype for e in engine.selection_log})
    log(f"launches in the {label} serve run: {launches}; the selections call for "
        f"{sorted(needed)}; fingerprints {fingerprints}")
    if sum(launches.values()) <= 0:
        raise AssertionError(f"the {label} serve run launched no kernel")
    for name in needed:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"{label}: {name} was selected but never launched")
    if rung is not None:
        unquantized = {e.tag for e in engine.selection_log
                       if RUNG_OF.get(e.op.in_dtype) != rung and e.tag != "moe.router"}
        if unquantized:
            raise AssertionError(f"{label}: {sorted(unquantized)} did not run on the rung")
    grouped = sum(1 for e in engine.selection_log if e.op.fused)
    b5 = sum(n for name, n in launches.items() if name.startswith("grouped_streamk"))
    if b5 != grouped:
        raise AssertionError(f"{label}: {b5} B5 launches for {grouped} grouped dispatches")
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
        raise AssertionError(f"{label}: {b5_per_step} B5 launches in a decode step, expected "
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
    if breakdown["cuda"]["fixup_ms"]:
        raise AssertionError(f"{label}: a fix-up kernel ran in a traced decode step "
                             f"({breakdown['cuda']['fixup_ms']} ms)")
    for backend, bd in breakdown.items():
        log(f"{label} warm decode step, {backend} backend: {bd['step_ms']:.2f} ms wall, "
            f"{bd['enqueue_ms']:.2f} ms host enqueue, device busy {bd['device_busy_ms']} ms "
            f"(GEMM kernels {bd['gemm_kernels_ms']} ms), idle share {bd['idle_share']}")
        for name, ms in bd["top_kernels"]:
            log(f"    {ms:9.3f} ms  {name}")
    per = lambda log_: {n: log_.count(n) for n in sorted(set(log_))}  # noqa: E731

    # the first request's prefill logits against the torch backend; for a
    # MoE model, count the routing choices the two backends made differently
    tol = LOGITS_TOL[arch] if rung is None else QUANT_LOGITS_TOL[arch, rung]
    # the dense MoE run holds its limit on the routing-replayed reading, with
    # the router GEMM checked on its own (see ROUTER_TOL)
    hold_replayed = cfg.family == "moe" and rung is None
    with routing_log(check_router=hold_replayed) as routes_cuda:
        got = engine.prefill_logits(prompts[0])
    with routing_log() as routes_torch, gemm_context(backend="torch"):
        want, _ = model.prefill(params, torch.as_tensor(prompts[0], device="cuda")[None])
    flips = routing_flips(routes_cuda, routes_torch)
    if got.shape != (1, 1, cfg.vocab_size) or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: bad prefill logits {tuple(got.shape)}")
    diff = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    # a second reading for a MoE model: the torch backend takes the cuda run's
    # top-k experts, so what is left is the kernels' rounding without the
    # routing flips it causes (held for the dense run, reported on a rung)
    replayed = None
    if cfg.family == "moe":
        with routing_replay(routes_cuda), gemm_context(backend="torch"):
            want_r, _ = model.prefill(params, torch.as_tensor(prompts[0], device="cuda")[None])
        replayed = (got.float() - want_r.float()).abs().max().item()
        del want_r
    held = replayed if hold_replayed else diff
    same_top = int(got.float().argmax()) == int(want.float().argmax())
    # the same check must catch a kernel that skips a K chunk: B1 under the
    # DP policy for the dense model, B5 for the MoE model; on a rung, every
    # DP and grouped GEMM of the rung; read as the limit is held
    fault, fault_replayed = planted_fault_diff(
        model, params, engine.selector, prompts[0], want, grouped=cfg.family == "moe",
        rung=rung, replay=hold_replayed)
    fault_held = fault_replayed if hold_replayed else fault
    breaches = []
    if held > tol * scale:
        what = "with the cuda run's routing replayed" if hold_replayed else "each routing alone"
        other = "" if replayed is None or hold_replayed else (
            f"; with the cuda run's routing replayed: max|diff| {replayed:.4f}")
        breaches.append(f"{label} prefill logits ({what}): max|diff| {held:.4f} > {tol} * "
                        f"{scale:.4f} (each routing alone: {diff:.4f}; routing flips: "
                        f"{flips}{other})")
    if hold_replayed and routes_cuda.router_err > ROUTER_TOL:
        breaches.append(f"{label}: router logits vs torch.matmul of the same input: max|err| "
                        f"{routes_cuda.router_err:.3e} > {ROUTER_TOL} x max(1, max|ref|)")
    if fault_held < 3 * tol * scale:
        breaches.append(f"{label}: a planted fault must read at least 3x the limit: max|diff| "
                        f"{fault_held:.4f} < 3 * {tol} * {scale:.4f}")
    failures.extend(breaches)
    # quantization error, reported and not limited: the rung's logits
    # against the dense bf16 run's on the same prompt
    vs_dense = None
    if dense_logits is not None:
        vs_dense = (got.float() - dense_logits.float()).abs().max().item()

    tm = engine.timing
    step_ms = tm["decode_s"] / max(tm["decode_steps"], 1) * 1e3
    floor_ms = weight_bytes / HBM_BW * 1e3
    st = engine.selector_stats
    picks = {}
    for e in engine.selection_log:
        s = e.selection
        g_part = f"G={e.op.g} " if e.op.kind == "grouped" else ""
        picks.setdefault(f"{e.tag} {g_part}{e.local_mnk} {e.op.in_dtype}",
                         f"{s.policy.name}/{s.cfg.name}/g{s.g}")
    serve = dict(
        arch=arch, rung=rung, fingerprints=fingerprints, logits=got,
        logits_vs_dense_max_abs_diff=vs_dense, breaches=breaches,
        requests=len(done), prompt_lens=[len(p) for p in prompts],
        prefill_tokens=tm["prefill_tokens"], prefill_s=tm["prefill_s"],
        prefill_tok_s=tm["prefill_tokens"] / tm["prefill_s"],
        decode_tokens=tm["decode_tokens"], decode_steps=tm["decode_steps"],
        decode_s=tm["decode_s"], decode_tok_s=tm["decode_tokens"] / tm["decode_s"],
        decode_step_ms=step_ms, decode_floor_ms=floor_ms, weight_bytes=weight_bytes,
        launches=launches, grouped_dispatches=grouped, launches_per_prefill=per(pre),
        prefill_len=len(prompts[0]), launches_per_decode_step=per(dec),
        decode_breakdown=breakdown, logits_max_abs_diff=diff, logits_max_abs=scale,
        logits_tol=tol, planted_fault_max_abs_diff=fault, same_argmax=same_top,
        routing_flips=flips, logits_replayed_routing_max_abs_diff=replayed,
        logits_held="replayed_routing" if hold_replayed else "own_routing",
        logits_held_max_abs_diff=held, planted_fault_held_max_abs_diff=fault_held,
        planted_fault_replayed_routing_max_abs_diff=fault_replayed,
        router_max_rel_err=routes_cuda.router_err if hold_replayed else None,
        selector=dict(lookups=st.lookups, cache_hits=st.cache_hits, fallbacks=st.fallbacks),
        tokens={r.uid: r.out_tokens for r in done}, picks=picks,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    log(f"{label} served 4/4: prefill {serve['prefill_tok_s']:.1f} tok/s, decode "
        f"{serve['decode_tok_s']:.1f} tok/s, decode step {step_ms:.2f} ms "
        f"(weight-read floor {floor_ms:.2f} ms)")
    log(f"launches per prefill ({len(prompts[0])} tokens): {serve['launches_per_prefill']}; "
        f"per decode step: {serve['launches_per_decode_step']}")
    log(f"{label} prefill logits vs torch backend: max|diff| {diff:.4f} (max|logit| "
        f"{scale:.4f}, limit {tol * scale:.4f}), same argmax: {same_top}; planted fault "
        f"{fault:.4f}; routing flips {flips}; vs the dense bf16 run: {vs_dense}")
    if replayed is not None:
        held_by = (f"held at the limit {tol}; the router logits read "
                   f"{routes_cuda.router_err:.3e} of limit {ROUTER_TOL}; planted fault "
                   f"{fault_replayed:.4f}" if hold_replayed
                   else f"reported, the limit {tol} holds the first reading")
        log(f"{label} prefill logits vs the torch backend replaying the cuda run's top-"
            f"{cfg.top_k} choices: max|diff| {replayed:.4f} ({replayed / scale:.3e} x max|logit|;"
            f" {held_by})")
    log(f"selector: {st.lookups} lookups, {st.cache_hits} cache hits, {st.fallbacks} cold picks")
    for key, val in sorted(picks.items()):
        log(f"  {key} -> {val}")
    return serve


#: layers of the int8-KV-cache phase: granite-8b at full width, its depth cut to 2
KV_INT8_LAYERS = 2


def phase_kv_int8():
    """granite-8b at full width and ``KV_INT8_LAYERS`` layers with
    ``kv_cache_dtype="int8"``, bf16, seeded weights: the engine serves the
    four prompts on the ``cuda`` backend (launch counters zeroed just
    before, read just after; every kernel the selections call for must have
    launched), the cache must be int8 with f32 scales, and the first
    prompt's prefill and two decode steps (fed the tokens the engine chose)
    must give logits within granite's ``LOGITS_TOL`` of the ``torch``
    backend. The same steps with the model-dtype cache are reported, not
    limited: that difference is the cache's quantization error."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.gemm import gemm_context
    from repro_torch.kernels.common import LAUNCHES, reset_launch_counts
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg = dataclasses.replace(get_config("granite-8b"), n_layers=KV_INT8_LAYERS,
                              kv_cache_dtype="int8")
    model = LM(cfg)
    params = model.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))
    engine = ServeEngine(model, params, ServeConfig(n_slots=N_SLOTS, max_seq=MAX_SEQ, eos=-1),
                         backend="cuda")
    prompts = serve_prompts(cfg.vocab_size)
    for p in prompts:
        engine.submit(p, max_new_tokens=8)
    reset_launch_counts()
    done = sorted(engine.run(), key=lambda r: r.uid)
    torch.cuda.synchronize()
    launches = {name: n for name, n in LAUNCHES.items() if n}
    needed = set()
    for e in engine.selection_log:
        needed |= _kernels_of(e)
    log(f"int8 KV cache, granite-8b x {KV_INT8_LAYERS} layers: launches {launches}; the "
        f"selections call for {sorted(needed)}")
    if len(done) != 4 or any(len(r.out_tokens) != 8 for r in done):
        raise AssertionError(f"int8 KV cache: served {len(done)}/4 requests")
    missing = [name for name in needed if launches.get(name, 0) <= 0]
    if missing or not needed:
        raise AssertionError(f"int8 KV cache: {missing} selected but never launched")
    dtypes = {key: str(v.dtype) for key, v in engine.cache["attn"].items()}
    if dtypes != {"k": "torch.int8", "v": "torch.int8", "k_scale": "torch.float32",
                  "v_scale": "torch.float32"}:
        raise AssertionError(f"int8 KV cache: the cache is {dtypes}")

    prompt = torch.as_tensor(prompts[0], device="cuda")[None]
    feed = done[0].out_tokens[:2]

    def decode_logits(lm, backend):
        with gemm_context(selector=engine.selector, backend=backend):
            out, cache = lm.prefill(params, prompt, max_seq=MAX_SEQ)
            steps = []
            for i, tok in enumerate(feed):
                pos = torch.tensor([prompt.shape[1] + i], device="cuda")
                out, cache = lm.decode_step(params, cache, torch.tensor([[tok]], device="cuda"),
                                            pos)
                steps.append(out.float())
        return torch.stack(steps)

    got = decode_logits(model, "cuda")
    want = decode_logits(model, "torch")
    model_cache = decode_logits(LM(dataclasses.replace(cfg, kv_cache_dtype="model")), "cuda")
    if got.shape != (2, 1, 1, cfg.vocab_size) or not torch.isfinite(got).all():
        raise AssertionError(f"int8 KV cache: bad decode logits {tuple(got.shape)}")
    tol = LOGITS_TOL["granite-8b"]
    diff = (got - want).abs().max().item()
    scale = want.abs().max().item()
    vs_model = (got - model_cache).abs().max().item()
    log(f"int8 KV cache decode logits (2 steps) vs torch backend: max|diff| {diff:.4f} "
        f"(max|logit| {scale:.4f}, limit {tol * scale:.4f}); vs the model-dtype cache "
        f"{vs_model:.4f} ({vs_model / scale:.2e} x max|logit|, reported)")
    if diff > tol * scale:
        raise AssertionError(f"int8 KV cache: decode logits max|diff| {diff:.4f} > {tol} * "
                             f"{scale:.4f}")
    return dict(layers=KV_INT8_LAYERS, launches=launches, needed=sorted(needed),
                cache_dtypes=dtypes, logits_max_abs_diff=diff, logits_max_abs=scale,
                logits_tol=tol, vs_model_dtype_cache_max_abs_diff=vs_model)


#: the tune phase: top-k budget of the card's sweeps, and olmoe-1b-7b's depth there (full
#: width; two layers reach every fingerprint kind its 16 do)
TUNE_TOP_K, TUNE_OLMOE_LAYERS = 5, 2


def phase_tune(failures):
    """The tuning slice's main path on the card (see the module docstring,
    phase 4): online adaptation timing the hand-written kernels while
    granite-8b (full) and olmoe-1b-7b (full width, ``TUNE_OLMOE_LAYERS``
    layers) serve; the journal replayed, calibrated and sieved; granite-8b
    served again from that warm ``SelectorState``. Hard checks append to
    ``failures``. Returns the phase's record."""
    import dataclasses
    import tempfile
    from collections import Counter

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import costmodel
    from repro_torch.core.adaptive import AdaptiveConfig, AdaptiveTuner
    from repro_torch.core.calibrate import (
        MIN_RECORDS,
        CalibrationError,
        calibrate_db,
        key_dtypes,
        profile_key,
    )
    from repro_torch.core.gemm import gemm_context
    from repro_torch.core.op import GemmOp
    from repro_torch.core.policies import HOPPER_TILE_CONFIGS
    from repro_torch.core.selector import KernelSelector, SelectorState, default_selector
    from repro_torch.core.tuner import Tuner, TuningDatabase, _key_shape, measure_wallclock
    from repro_torch.kernels.common import LAUNCHES, reset_launch_counts
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    t_phase = time.perf_counter()
    h100 = costmodel.H100
    bf16 = profile_key(costmodel.profile_for("bfloat16"))
    granite = LM(get_config("granite-8b"))
    granite_params = granite.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))
    prompts = serve_prompts(granite.cfg.vocab_size)
    tmp = tempfile.TemporaryDirectory()
    journal = str(Path(tmp.name) / "tune.jsonl")

    def engine_for(model, params, selector=None, adaptive=None):
        eng = ServeEngine(model, params, ServeConfig(n_slots=N_SLOTS, max_seq=MAX_SEQ, eos=-1),
                          backend="cuda", selector=selector, adaptive=adaptive,
                          adapt_every=1 if adaptive is not None else 0)
        for p in serve_prompts(model.cfg.vocab_size):
            eng.submit(p, max_new_tokens=8)
        return eng

    # 1. cold: every fingerprint misses once (hot_threshold=1), is timed on the kernels
    #    between decode steps (top-k budget) and journaled
    cold = TuningDatabase()
    selector = KernelSelector(mach=h100, tile_configs=HOPPER_TILE_CONFIGS,
                              state=SelectorState(db=cold, sieve=cold.build_sieve()))
    tuner = Tuner(policies=selector.policies, tile_configs=selector.tile_configs,
                  measure_fn=measure_wallclock(), mach=h100, grid_sizes=selector.grid_sizes,
                  top_k=TUNE_TOP_K)
    adaptive = AdaptiveTuner(selector, tuner=tuner, journal=journal,
                             config=AdaptiveConfig(hot_threshold=1, top_k=TUNE_TOP_K))
    served = {}
    t0 = time.perf_counter()
    eng = engine_for(granite, granite_params, adaptive=adaptive)
    done = eng.run()
    served["granite-8b"] = dict(requests=len(done), seconds=time.perf_counter() - t0,
                                records=len(cold.records), measurements=tuner.measurements)
    olmoe = LM(dataclasses.replace(get_config("olmoe-1b-7b"), n_layers=TUNE_OLMOE_LAYERS))
    olmoe_params = olmoe.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))
    t0 = time.perf_counter()
    eng = engine_for(olmoe, olmoe_params, adaptive=adaptive)
    done_o = eng.run()
    served["olmoe-1b-7b"] = dict(requests=len(done_o), seconds=time.perf_counter() - t0,
                                 records=len(cold.records), measurements=tuner.measurements)
    del olmoe_params
    if len(done) != 4 or len(done_o) != 4:
        failures.append(f"tune: served {len(done)}/4 granite and {len(done_o)}/4 olmoe requests")
    fused = [k for k in cold.records if len(k) == 8]
    if not fused:
        failures.append("tune: no fused grouped fingerprint was tuned")
    n_bf16 = sum(profile_key(key_dtypes(k)) == bf16 for k in cold.records)
    extra = []
    if n_bf16 < MIN_RECORDS:
        # the baseline comparison's shapes (phase 2) as GemmOp targets, so the bf16 fit
        # has the records it needs; MIN_RECORDS stays as it is
        extra = [GemmOp.plain(m, n, k, in_dtype="bfloat16") for m in (N_SLOTS, PROMPT_M)
                 for n, k in SLICE_NK]
        extra = [op for op in extra if op.key not in cold.records]
        tuner.tune(extra, journal=journal)
    log(f"tune: cold serve adapted {adaptive.stats.adaptations} fingerprints "
        f"({adaptive.stats.misses} misses, sieve generation {selector.sieve_generation}); "
        f"{len(extra)} baseline-comparison targets tuned besides; {tuner.measurements} "
        f"measurements")

    # 2. the journal replayed into a fresh database, its snapshot round trip, the
    #    calibration and the sieve
    db = TuningDatabase()
    db.replay_journal(journal)
    snap = str(Path(tmp.name) / "tune.json")
    db.save(snap)
    back = TuningDatabase.load(snap)
    as_dicts = lambda d: {k: dataclasses.asdict(r) for k, r in d.records.items()}  # noqa: E731
    if as_dicts(back) != as_dicts(db) or back.per_policy != db.per_policy or db.load_errors:
        failures.append("tune: the snapshot round trip changed the records")
    n_bf16 = sum(profile_key(key_dtypes(k)) == bf16 for k in db.records)
    cm = None
    try:
        cm = calibrate_db(db, base=h100)
    except CalibrationError as e:
        failures.append(f"tune: calibration refused: {e}")
    if cm is not None and (bf16 not in cm.fitted_profiles or n_bf16 < MIN_RECORDS):
        failures.append(f"tune: the bf16 profile fitted on {n_bf16} records "
                        f"(MIN_RECORDS {MIN_RECORDS}), fitted {cm.fitted_profiles}")
    if cm is not None:
        db.set_calibration(cm)
    sieve = db.build_sieve()
    try:
        tn = sieve.validate_true_negative_rate(db.winners())
    except AssertionError as e:  # a winner the sieve prunes
        tn = str(e)
    for key in db.records:
        sieve.candidates(key)
    elim = sieve.stats.elimination_rate
    if tn != 1.0:
        failures.append(f"tune: the sieve's true-negative rate is {tn}")
    terms = lambda m: dict(peak_tflops=m.peak_flops / 1e12, hbm_gbps=m.hbm_bw / 1e9,  # noqa: E731
                           launch_us=m.launch_overhead_s * 1e6,
                           fixup_us=m.fixup_serial_s * 1e6)
    fitted = {pk: terms(m) for pk, m in cm.profiles} if cm is not None else {}
    ranker = Tuner(policies=selector.policies, tile_configs=selector.tile_configs, mach=h100,
                   grid_sizes=selector.grid_sizes)

    def ranks(calibration):
        ranker.calibration = calibration
        return dict(sorted(Counter(
            ranker._model_rank(_key_shape(k, k), key_dtypes(k), r.policy, r.cfg, r.g)
            for k, r in db.records.items()).items()))

    rank_nominal, rank_fitted = ranks(None), ranks(cm) if cm is not None else None
    by_policy = dict(sorted(Counter(r.policy for r in db.records.values()).items()))
    by_g = dict(sorted(Counter(r.g for r in db.records.values()).items()))
    dp_share = by_policy.get("dp", 0) / max(len(db.records), 1)
    log(f"tune: {len(db.records)} records replayed from the journal; winners by policy "
        f"{by_policy}, by g {by_g} (DP share {dp_share:.3f}); sieve true-negative rate {tn}, "
        f"elimination rate over the tuned keys {elim:.4f}")
    log(f"tune: nominal H100 {terms(h100)}; calibrated "
        f"{ {pk: {k: round(v, 3) for k, v in t.items()} for pk, t in fitted.items()} }, median "
        f"|rel resid| {cm.residual if cm is not None else None}; winner model_rank nominal "
        f"{rank_nominal}, calibrated {rank_fitted}")

    # 3. granite-8b served again from the warm state: launch counters zeroed just before and
    #    read just after; every dispatch a database hit; logits against the torch backend
    warm = KernelSelector(mach=h100, tile_configs=HOPPER_TILE_CONFIGS,
                          state=SelectorState(db=db, sieve=sieve, calibration=cm))
    eng = engine_for(granite, granite_params, selector=warm)
    reset_launch_counts()
    done = eng.run()
    torch.cuda.synchronize()
    launches = {name: n for name, n in LAUNCHES.items() if n}
    needed = set()
    for e in eng.selection_log:
        needed |= _kernels_of(e)
    sources = dict(Counter(e.selection.source for e in eng.selection_log))
    st = warm.stats
    if len(done) != 4 or sources != {"tuned": len(eng.selection_log)} or (
            st.sieve_hits or st.fallbacks or st.model_warm or st.xarch_seeds):
        failures.append(f"tune: warm serve {len(done)}/4, sources {sources} (sieve "
                        f"{st.sieve_hits}, fallback {st.fallbacks}, model {st.model_warm})")
    missing = sorted(name for name in needed if not launches.get(name))
    if missing or not needed:
        failures.append(f"tune: the warm serve never launched {missing}")
    got = eng.prefill_logits(prompts[0])
    with gemm_context(backend="torch"):
        want, _ = granite.prefill(granite_params, torch.as_tensor(prompts[0], device="cuda")[None])
    diff = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    tol = LOGITS_TOL["granite-8b"]
    if not torch.isfinite(got).all() or diff > tol * scale:
        failures.append(f"tune: warm prefill logits max|diff| {diff:.4f} > {tol} * {scale:.4f}")

    # 4. a warm decode step's GEMM device ms: the tuned picks beside the nominal model's
    cur = torch.zeros(N_SLOTS, dtype=torch.long, device="cuda")
    toks = torch.ones(N_SLOTS, 1, dtype=torch.long, device="cuda")
    scratch = granite.init_cache(N_SLOTS, MAX_SEQ, device="cuda")

    def step():
        granite.decode_step(granite_params, scratch, toks, cur)

    steps = {}
    for name, sel in (("nominal", default_selector("cuda")), ("tuned", warm)):
        with gemm_context(selector=sel, backend="cuda"):
            steps[name] = decode_breakdown(step)
    del scratch
    tmp.cleanup()
    del granite_params
    for name, bd in steps.items():
        log(f"tune: warm decode step, {name} picks: GEMM kernels {bd['gemm_kernels_ms']} ms, "
            f"device busy {bd['device_busy_ms']} ms, {bd['step_ms']:.2f} ms wall")
    seconds = time.perf_counter() - t_phase
    log(f"tune: warm serve launches {launches}; logits vs torch backend max|diff| {diff:.4f} "
        f"(limit {tol * scale:.4f}); phase {seconds:.1f}s")
    return dict(
        seconds=seconds, measurements=tuner.measurements, records=len(db.records),
        served=served, extra_targets=len(extra), adaptations=adaptive.stats.adaptations,
        misses=adaptive.stats.misses, sieve_generation=selector.sieve_generation,
        fused_records=len(fused), bf16_records=n_bf16, winners_by_policy=by_policy,
        winners_by_g=by_g, dp_share=dp_share, true_negative_rate=tn, elimination_rate=elim,
        nominal=terms(h100), calibrated=fitted,
        calibration_records=cm.n_records if cm is not None else 0,
        calibration_residual=cm.residual if cm is not None else None,
        model_rank_nominal=rank_nominal, model_rank_calibrated=rank_fitted,
        warm_sources=sources, warm_launches=launches, warm_logits_max_abs_diff=diff,
        warm_logits_max_abs=scale, logits_tol=tol,
        decode_gemm_ms={name: bd["gemm_kernels_ms"] for name, bd in steps.items()},
        decode_breakdown=steps,
    )


# ---------------------------------------------------------------------------
# Phase 5: paged serving and the fleet
# ---------------------------------------------------------------------------


#: the paged pool of phase 5: 16-row pages, the dense engine's rows (N_SLOTS x MAX_SEQ / 16
#: = 64 pages, the equal-memory pool), N_SLOTS active, and the chunk of chunked prefill
PAGE_SIZE, PREFILL_CHUNK = 16, 16
#: olmoe-1b-7b's depth in phase 5 (b): full width, two layers reach every fingerprint kind
PAGED_OLMOE_LAYERS = 2


def _paged_engine(model, params, chunk):
    """A ``PagedServeEngine`` of phase 5 on the card and the ``cuda``
    backend; raises if its pool or its GEMMs would run anywhere else."""
    from repro_torch.serve import PagedServeConfig, PagedServeEngine

    eng = PagedServeEngine(model, params, PagedServeConfig(
        page_size=PAGE_SIZE, max_pages=N_SLOTS * MAX_SEQ // PAGE_SIZE, max_active=N_SLOTS,
        max_seq=MAX_SEQ, prefill_chunk=chunk, eos=-1), backend="cuda")
    where = {key: a.device.type for key, a in eng.kv.pool["attn"].items()}
    if eng.backend != "cuda" or eng.device.type != "cuda" or set(where.values()) != {"cuda"}:
        raise AssertionError(f"paged engine off the card: backend {eng.backend}, device "
                             f"{eng.device}, pool {where}")
    return eng


def paged_run(label, model, params, chunk, dense_tokens=None):
    """Serve the four prompts through a paged engine (``chunk`` 0: whole-
    prompt prefill), launch counters zeroed just before and read just after:
    every kernel the selections call for must have launched, and each fused
    grouped dispatch must be exactly one B5 launch. Returns the run's
    record (timing, pool and admission counters, tokens against
    ``dense_tokens`` by request)."""
    import torch

    from repro_torch.kernels.common import LAUNCHES, reset_launch_counts

    cfg = model.cfg
    eng = _paged_engine(model, params, chunk)
    for p in serve_prompts(cfg.vocab_size):
        eng.submit(p, max_new_tokens=8)
    reset_launch_counts()
    done = sorted(eng.run(), key=lambda r: r.uid)
    torch.cuda.synchronize()
    launches = {name: n for name, n in LAUNCHES.items() if n}
    if len(done) != 4 or eng.exhausted or any(len(r.out_tokens) != 8 for r in done):
        raise AssertionError(f"{label}: served {len(done)}/4 requests")
    needed = set()
    for e in eng.selection_log:
        needed |= _kernels_of(e)
    missing = [name for name in needed if launches.get(name, 0) <= 0]
    if missing or not needed:
        raise AssertionError(f"{label}: {missing} selected but never launched")
    grouped = sum(1 for e in eng.selection_log if e.op.fused)
    b5 = sum(n for name, n in launches.items() if name.startswith("grouped_streamk"))
    if b5 != grouped:
        raise AssertionError(f"{label}: {b5} B5 launches for {grouped} grouped dispatches")
    tokens = {r.uid: r.out_tokens for r in done}
    agree = None
    if dense_tokens is not None:
        agree = sum(a == b for uid, toks in tokens.items()
                    for a, b in zip(toks, dense_tokens[uid]))
    tm, m = eng.timing, eng.metrics()
    step_ms = tm["decode_s"] / max(tm["decode_steps"], 1) * 1e3
    log(f"{label}: launches {launches}; {grouped} grouped dispatches; decode step "
        f"{step_ms:.2f} ms wall over {tm['decode_steps']} steps, prefill {tm['prefill_s']:.3f}s "
        f"for {tm['prefill_tokens']} tokens; pool peak {m['peak_used_pages']}/{m['n_pages']} "
        f"pages, peak {m['peak_resident']} resident; admitted {m['admitted']}, rejected "
        f"{m['rejected']}, truncated {m['truncated']}, stall events {m['stall_events']}; "
        f"greedy tokens equal to the dense run's: {agree}/32")
    return dict(chunk=chunk, launches=launches, needed=sorted(needed), grouped=grouped,
                timing=dict(tm), decode_step_ms=step_ms, metrics=m, tokens=tokens,
                tokens_equal_dense=agree)


def paged_decode_check(model, params, failures):
    """One paged decode step (gather the view, the unchanged decode step on
    it, scatter the new rows) against the dense engine's step on the same
    prefilled requests and tokens, both on the ``cuda`` backend, held at
    granite's ``LOGITS_TOL``; then the planted fault, request 0's first
    page-table entry pointing at request 1's first page, which must read at
    least 3 times the limit. Also times the step's gather on its own."""
    import torch

    from repro_torch.core.gemm import gemm_context
    from repro_torch.serve import PageTable, ServeConfig, ServeEngine

    prompts = serve_prompts(model.cfg.vocab_size)
    dense = ServeEngine(model, params, ServeConfig(n_slots=N_SLOTS, max_seq=MAX_SEQ, eos=-1),
                        backend="cuda")
    paged = _paged_engine(model, params, 0)
    for eng in (dense, paged):
        for p in prompts:
            eng.submit(p, max_new_tokens=8)
    dense._admit()
    paged._admit()
    while paged._prefill_tick():
        pass
    reqs = paged._decode_candidates()
    if len(reqs) != 4:
        raise AssertionError(f"paged decode check: {len(reqs)} requests prefilled of 4")
    tokens = np.array([[r.out_tokens[-1]] for r in dense.slot_req], np.int64)
    pos = np.array([r.pos for r in reqs], np.int64)
    if not (pos == dense.pos).all():
        raise AssertionError(f"paged decode check: positions {pos} vs dense {dense.pos}")
    tables = [r.table for r in reqs]
    with gemm_context(selector=dense.selector, backend="cuda"):
        want, _ = model.decode_step(params, dense.cache, torch.as_tensor(tokens, device="cuda"),
                                    torch.as_tensor(dense.pos, device="cuda"))
    with paged._dispatch_ctx():
        got = paged._paged_decode(paged.kv.padded_tables(tables), tokens, pos, 4)
        bad_tables = [PageTable([reqs[1].table.pages[0]] + reqs[0].table.pages[1:])] + tables[1:]
        bad = paged._paged_decode(paged.kv.padded_tables(bad_tables), tokens, pos, 4)
    got, want, bad = got.float(), want.float(), bad.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"paged decode check: bad logits {tuple(got.shape)}")
    tol = LOGITS_TOL["granite-8b"]
    diff = (got - want).abs().max().item()
    scale = want.abs().max().item()
    fault = (bad - want).abs().max().item() if torch.isfinite(bad).all() else math.inf
    log(f"paged decode step vs the dense engine's step (granite-8b, cuda backend): max|diff| "
        f"{diff:.4f} (max|logit| {scale:.4f}, limit {tol * scale:.4f}); planted fault (request "
        f"0's first page -> request 1's) {fault:.4f} (must be >= {3 * tol * scale:.4f})")
    if diff > tol * scale:
        failures.append(f"paged decode logits: max|diff| {diff:.4f} > {tol} * {scale:.4f}")
    if fault < 3 * tol * scale:
        failures.append(f"paged decode planted fault must read at least 3x the limit: "
                        f"{fault:.4f} < 3 * {tol} * {scale:.4f}")
    # the gather of the run's largest view: 5 pages a request (prompt and 8
    # new tokens), padded to 8
    pages_2d = paged.kv.padded_tables(
        [PageTable(r.table.pages + paged.kv.alloc(5 - len(r.table.pages))) for r in reqs])
    view = paged.kv.gather_view(paged.kv.pool, pages_2d)
    gather_bytes = 2 * sum(a.numel() * a.element_size() for a in view["attn"].values())
    gather_ms, gather_event_ms = time_ms(lambda: paged.kv.gather_view(paged.kv.pool, pages_2d))
    log(f"gather of a decode step's view {tuple(view['attn']['k'].shape)}: {gather_ms:.4f} ms "
        f"device ({gather_event_ms:.4f} event), {gather_bytes / 1e6:.1f} MB read and written, "
        f"{gather_bytes / gather_ms / 1e6:.0f} GB/s")
    return dict(logits_max_abs_diff=diff, logits_max_abs=scale, logits_tol=tol,
                planted_fault_max_abs_diff=fault, gather_view_shape=list(view["attn"]["k"].shape),
                gather_ms=gather_ms, gather_event_ms=gather_event_ms, gather_bytes=gather_bytes)


def chunked_prefill_check(model, params, failures, *, tol, routing=False):
    """Prefill the first prompt through a paged engine in ``PREFILL_CHUNK``
    chunks; its last chunk's logits against the whole-prompt prefill on the
    ``cuda`` backend (``routing``: against the ``torch`` backend replaying
    the chunked run's top-k choices, with the router logits held against
    ``torch.matmul`` at ``ROUTER_TOL``), within ``tol`` x max|logit|; then
    the planted fault, the last chunk attending over a zeroed prefix (a
    view without its cache prefix), which must read at least 3 times the
    limit."""
    import torch

    from repro_torch.core.gemm import gemm_context

    label = f"{model.cfg.name} chunked prefill"
    prompt = serve_prompts(model.cfg.vocab_size)[0]
    tokens = torch.as_tensor(prompt, device="cuda")[None]
    eng = _paged_engine(model, params, PREFILL_CHUNK)
    eng.submit(prompt, max_new_tokens=8)
    eng._admit()
    req = eng.active[0]
    chunks = []
    paged_chunk = eng._paged_chunk

    def recording(*a):
        chunks.append(paged_chunk(*a))
        return chunks[-1]

    eng._paged_chunk = recording
    with routing_log(check_router=routing) as routes:
        while len(prompt) - req.prefilled > PREFILL_CHUNK:
            eng._prefill_tick()
        start = req.prefilled
        eng._prefill_tick()  # the last chunk
    got = chunks[-1].float()
    view = eng.kv.gather_view(eng.kv.pool, eng.kv.padded_tables([req.table]))
    for leaf in view["attn"].values():
        leaf[:, :, :start] = 0
    with routing_log() as bad_routes, eng._dispatch_ctx():
        bad, _ = model.prefill_chunk(params, view, tokens[:, start:],
                                     torch.tensor([start], device="cuda"))
    if routing:
        def chained(replay):
            with routing_replay(replay), gemm_context(backend="torch"):
                out, cache = model.prefill(params, tokens[:, :PREFILL_CHUNK], max_seq=MAX_SEQ)
                for s in range(PREFILL_CHUNK, len(prompt), PREFILL_CHUNK):
                    out, cache = model.prefill_chunk(params, cache, tokens[:, s:s + PREFILL_CHUNK],
                                                     torch.tensor([s], device="cuda"))
            return out.float()

        want = chained(routes)
        bad_want = chained(routes[:-len(bad_routes)] + list(bad_routes))
    else:
        with gemm_context(selector=eng.selector, backend="cuda"):
            want, _ = model.prefill(params, tokens)
        want = bad_want = want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: bad logits {tuple(got.shape)}")
    diff = (got - want).abs().max().item()
    scale = want.abs().max().item()
    fault = (bad.float() - bad_want).abs().max().item() if torch.isfinite(bad).all() else math.inf
    against = ("the torch backend replaying its top-k choices, chunk by chunk" if routing
               else "the whole-prompt prefill")
    log(f"{label} ({len(prompt)} tokens, {len(chunks) + 1} chunks of {PREFILL_CHUNK}) vs "
        f"{against}: max|diff| {diff:.4f} (max|logit| {scale:.4f}, limit {tol * scale:.4f}); "
        f"planted fault (the last chunk without its prefix) {fault:.4f} (must be >= "
        f"{3 * tol * scale:.4f})" + (f"; router logits vs torch.matmul {routes.router_err:.3e} "
                                     f"(limit {ROUTER_TOL})" if routing else ""))
    if diff > tol * scale:
        failures.append(f"{label}: max|diff| {diff:.4f} > {tol} * {scale:.4f}")
    if fault < 3 * tol * scale:
        failures.append(f"{label}: the planted fault must read at least 3x the limit: "
                        f"{fault:.4f} < 3 * {tol} * {scale:.4f}")
    if routing and routes.router_err > ROUTER_TOL:
        failures.append(f"{label}: router logits vs torch.matmul {routes.router_err:.3e} > "
                        f"{ROUTER_TOL}")
    return dict(prompt_len=len(prompt), chunks=len(chunks) + 1, logits_max_abs_diff=diff,
                logits_max_abs=scale, logits_tol=tol, planted_fault_max_abs_diff=fault,
                router_max_rel_err=routes.router_err if routing else None)


def phase_paged_granite(model, params, runs, failures):
    """Phase 5 (a): granite-8b at full width on phase 3's bf16 weights,
    paged, whole-prompt and chunked (see the module docstring)."""
    t0 = time.perf_counter()
    dense = runs["dense"]
    dense_tokens = {int(uid): toks for uid, toks in dense["tokens"].items()}
    out = dict(whole=paged_run("granite-8b paged", model, params, 0, dense_tokens),
               chunked=paged_run(f"granite-8b paged, chunks of {PREFILL_CHUNK}", model, params,
                                 PREFILL_CHUNK, dense_tokens))
    for name in ("dp_gemm_region", "streamk_phase1"):  # B1 and B2 on the cuda backend
        for run in ("whole", "chunked"):
            if out[run]["launches"].get(name, 0) <= 0:
                raise AssertionError(f"granite-8b paged ({run}): {name} never launched")
    out["decode"] = paged_decode_check(model, params, failures)
    out["chunk"] = chunked_prefill_check(model, params, failures, tol=LOGITS_TOL["granite-8b"])
    out["dense_decode_step_ms"] = dense["decode_step_ms"]
    out["seconds"] = time.perf_counter() - t0
    log(f"granite-8b wall ms per decode step: paged {out['whole']['decode_step_ms']:.2f} "
        f"(chunked {out['chunked']['decode_step_ms']:.2f}) beside dense "
        f"{dense['decode_step_ms']:.2f} (phase 3); phase 5 (a) {out['seconds']:.1f}s")
    return out


def phase_paged_olmoe(failures):
    """Phase 5 (b): olmoe-1b-7b at full width and ``PAGED_OLMOE_LAYERS``
    layers, paged with chunked prefill: one B5 launch per fused grouped
    dispatch, and the chunked logits held as phase 3 holds olmoe's."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM

    t0 = time.perf_counter()
    model = LM(dataclasses.replace(get_config("olmoe-1b-7b"), n_layers=PAGED_OLMOE_LAYERS))
    params = model.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))
    out = dict(run=paged_run(f"olmoe-1b-7b x {PAGED_OLMOE_LAYERS} layers paged, chunks of "
                             f"{PREFILL_CHUNK}", model, params, PREFILL_CHUNK))
    if out["run"]["grouped"] <= 0:
        raise AssertionError("olmoe-1b-7b paged: no fused grouped dispatch")
    out["chunk"] = chunked_prefill_check(model, params, failures,
                                         tol=LOGITS_TOL["olmoe-1b-7b"], routing=True)
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_fleet_cli(failures):
    """Phase 5 (c): the serve CLI at full width, in this process through
    ``main(argv)``: granite-8b, paged with chunked prefill, poisson replay,
    two gossiping workers adapting online into a temporary journal; then the
    same command with ``--merge-journals`` and without ``--adapt``, where
    every decode dispatch must be a database hit."""
    import os
    import tempfile

    import torch

    from repro_torch.kernels.common import LAUNCHES, reset_launch_counts
    from repro_torch.launch import serve as cli

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        base = ["--arch", "granite-8b", "--preset", "full", "--paged", "--prefill-chunk",
                str(PREFILL_CHUNK), "--replay", "poisson", "--requests", "8", "--slots",
                str(N_SLOTS), "--max-seq", str(MAX_SEQ), "--max-new-tokens", "8", "--workers",
                "2", "--journal", os.path.join(tmp, "fleet.jsonl"), "--top-k", "5",
                "--gossip-every", "2"]
        for name, extra in (("adapt", ["--adapt", "--adapt-every", "1"]),
                            ("merged", ["--merge-journals"])):
            summary = os.path.join(tmp, f"{name}.json")
            reset_launch_counts()
            t0 = time.perf_counter()
            rc = cli.main(base + extra + ["--summary-json", summary])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = {n: c for n, c in LAUNCHES.items() if c}
            with open(summary) as f:
                run = json.load(f)
            run.update(rc=rc, seconds=seconds, launches=launches)
            out[name] = run
            gc.collect()
            torch.cuda.empty_cache()
            label = f"serve CLI ({name})"
            if rc != 0 or run["completed"] != 8:
                raise AssertionError(f"{label}: rc {rc}, {run['completed']}/8 requests")
            if not run["device"].startswith("cuda") or {w["backend"] for w in run["workers"]} != {
                    "cuda"}:
                raise AssertionError(f"{label}: served on {run['device']}, backends "
                                     f"{[w['backend'] for w in run['workers']]}")
            for kernel in ("dp_gemm_region", "streamk_phase1"):
                if launches.get(kernel, 0) <= 0:
                    raise AssertionError(f"{label}: {kernel} never launched")
            for w in run["workers"]:
                m, slo, gs = w["pool"], w.get("slo_steps", {}), w.get("gossip", {})
                step_ms = w["timing"]["decode_s"] / max(w["timing"]["decode_steps"], 1) * 1e3
                log(f"{label} worker {w['worker']}: {w['completed']}/{w['requests']} requests, "
                    f"decode {step_ms:.2f} ms/step wall; pool peak {m['peak_used_pages']}/{m['n_pages']} pages, peak "
                    f"{m['peak_resident']} resident; admitted {m['admitted']}, rejected "
                    f"{m['rejected']}, truncated {m['truncated']}, stalls {m['stall_events']}; SLO "
                    f"steps latency p50 {slo.get('latency_p50')} p99 {slo.get('latency_p99')}, "
                    f"ttft p50 {slo.get('ttft_p50')} p99 {slo.get('ttft_p99')}; gossip "
                    f"{gs.get('rounds')} rounds, {gs.get('entries')} entries, "
                    f"{gs.get('swaps')} swaps; sources {w['sources']}, decode "
                    f"{w['decode_sources']}")
            fed = run.get("federation", {})
            log(f"{label}: rc {rc} in {seconds:.1f}s; launches {launches}; fleet journals "
                f"federate to {fed.get('records')} records, {fed.get('conflicts')} conflicts")
        w1 = out["adapt"]["workers"][1]["gossip"]
        if w1["rounds"] <= 0 or w1["entries"] <= 0:
            failures.append(f"serve CLI: worker 1's gossip absorbed nothing: {w1}")
        for w in out["merged"]["workers"]:
            if set(w["decode_sources"]) != {"tuned"}:
                failures.append(f"serve CLI --merge-journals: worker {w['worker']}'s decode "
                                f"dispatches were {w['decode_sources']}, not all tuned")
    return out


def phase_paged(granite, failures):
    """Phase 5 (b) and (c), with (a) run beforehand inside phase 3
    (``granite``, on its weights); returns the phase's record."""
    t0 = time.perf_counter()
    out = dict(granite=granite, olmoe=phase_paged_olmoe(failures))
    gc.collect()
    import torch

    torch.cuda.empty_cache()
    out["cli"] = phase_fleet_cli(failures)
    out["seconds"] = time.perf_counter() - t0 + granite["seconds"]
    log(f"phase 5 (paged serving and the fleet): {out['seconds']:.1f}s")
    return out


class Routes(list):
    """Each MoE layer's top-k expert choice ((T, k) indices) in call order,
    and ``router_err``: the largest max|diff| of a layer's router logits
    against ``torch.matmul`` of the same input, over max(1, max|ref|)."""

    router_err = 0.0


@contextmanager
def routing_log(check_router=False):
    """Record each MoE layer's top-k expert choice ((T, k) indices) while the
    block runs, under whatever backend is active. The router GEMM is issued
    once more for the record; nothing else changes. With ``check_router``,
    the router logits are also held against ``torch.matmul`` of the layer's
    own input (``Routes.router_err``)."""
    import torch

    from repro_torch.core.gemm import gemm
    from repro_torch.models import layers

    routes = Routes()
    moe_apply = layers.moe_apply

    def recording(p, x, cfg, *, div):
        xf = x.reshape(-1, x.shape[-1]).float()
        logits = gemm(xf, p["router"], tag="moe.router")
        if check_router:
            ref = torch.matmul(xf, p["router"].float())
            err = (logits.float() - ref).abs().max().item() / max(1.0, ref.abs().max().item())
            routes.router_err = max(routes.router_err, err)
        routes.append(torch.topk(torch.softmax(logits, -1), cfg.top_k, dim=-1).indices)
        return moe_apply(p, x, cfg, div=div)

    layers.moe_apply = recording
    try:
        yield routes
    finally:
        layers.moe_apply = moe_apply


@contextmanager
def routing_replay(routes):
    """Make each MoE layer take, in call order, the top-k experts of
    ``routes`` (one (T, k) index tensor per layer, as ``routing_log``
    records them) in place of its own choice; the gates are the layer's own
    probabilities at those experts."""
    import torch

    from repro_torch.models import layers

    moe_apply = layers.moe_apply
    queue = iter(routes)

    def replaying(p, x, cfg, *, div):
        idx = next(queue)
        topk = torch.topk
        torch.topk = lambda probs, k, dim=-1: (probs.gather(dim, idx), idx)
        try:
            return moe_apply(p, x, cfg, div=div)
        finally:
            torch.topk = topk

    layers.moe_apply = replaying
    try:
        yield
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


def planted_fault_diff(model, params, selector, prompt, want, *, grouped, rung=None,
                       replay=False):
    """max|logit diff| against ``want`` of a prefill whose GEMMs of one kind
    drop their last K chunk (``cfg.bk`` of K): the DP-policy GEMMs (the
    reading a B1 that skips one chunk of its K loop would give), or, with
    ``grouped``, every fused grouped GEMM (a B5 that does the same); on a
    quantized ``rung``, every DP-policy and grouped GEMM of the rung. A
    non-finite prefill reads as infinitely far. Returns that and, with
    ``replay``, the same prefill against the ``torch`` backend replaying its
    top-k choices (else None)."""
    import torch

    from repro_torch.core.gemm import gemm_context, get_backend, register_backend
    from repro_torch.core.policies import DP

    cuda = get_backend("cuda")

    def drop_last_k_chunk(x, w, *, op, policy, cfg, **kw):
        if rung is not None:
            hit = RUNG_OF.get(op.in_dtype) == rung and (op.fused or policy == DP)
        else:
            hit = op.fused if grouped else policy == DP
        if hit and x.shape[-1] > cfg.bk:
            kk = x.shape[-1] - cfg.bk  # a multiple of bk: even, so packed int4 rows are kk / 2
            kw_rows = kk // 2 if kw.get("b_bits") == 4 else kk
            x, w = x[..., :kk].contiguous(), w[:, :kw_rows].contiguous()
        return cuda(x, w, op=op, policy=policy, cfg=cfg, **kw)

    register_backend("cuda_planted_fault", drop_last_k_chunk, overwrite=True)
    tokens = torch.as_tensor(prompt, device="cuda")[None]
    with routing_log() as routes, gemm_context(selector=selector, backend="cuda_planted_fault"):
        bad, _ = model.prefill(params, tokens)
    if not torch.isfinite(bad).all():
        return math.inf, math.inf if replay else None
    replayed = None
    if replay:
        with routing_replay(routes), gemm_context(backend="torch"):
            want_r, _ = model.prefill(params, tokens)
        replayed = (bad.float() - want_r.float()).abs().max().item()
    return (bad.float() - want.float()).abs().max().item(), replayed


#: name fragments of the hand-written kernels in profiler traces
GEMM_KERNELS = ("dp_fma_kernel", "dp_mma_kernel", "dp_s8_kernel", "streamk_kernel",
                "grouped_sk_kernel", "grouped_dp_kernel")


def decode_breakdown(step, iters=5):
    """Where a warm decode step's time goes: wall time (host clock ending in
    a synchronise), the host's enqueue time (until ``step`` returns), and,
    from one ``torch.profiler`` trace, the device's busy time, the share of
    it in the GEMM kernels, the device ms of any kernel named a fix-up (B3
    is fused into B2: none should run), and the busiest kernels by name."""
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
        fixup_ms=sum(v for name, v in by_name.items() if "fixup" in name),
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
    t0 = time.perf_counter()
    q_errs, q_cases, q_bitwise = quant_sweep(gen)
    log(f"quantized sweep {QUANT_SWEEP_SHAPES} x {[p[0] for p in QUANT_PAIRS]}: {q_cases} cases "
        f"agree with the plain versions and dequantize-then-matmul; max errors {q_errs}; "
        f"{q_bitwise} B2+B3 bitwise repeats ({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    qg_errs, qg_cases, qg_bitwise = quant_sweep_grouped(gen)
    log(f"quantized B5 sweep {QUANT_GROUPED_SHAPES}: {qg_cases} cases agree with the plain "
        f"version and dequantize-then-matmul; max errors {qg_errs}; {qg_bitwise} split-tile "
        f"cases bitwise deterministic ({time.perf_counter() - t0:.1f}s)")
    timed = time_kernels(gen)
    log("main-path GEMMs, decode (M=4) and prompt (M=64):")
    gemms = time_main_path_gemms(gen, 4) + time_main_path_gemms(gen, 64)
    log("B5 at olmoe-1b-7b's expert shapes:")
    grouped_rows = time_grouped(gen)
    for name in ("grouped_streamk_sk", "grouped_streamk_dp"):
        timed[name] = grouped_entry(grouped_rows, name)
    log("the quantized kernels at the decode and prompt shapes of each rung:")
    t0 = time.perf_counter()
    quant_rows = time_quant(gen)
    log(f"quantized timings ({time.perf_counter() - t0:.1f}s)")
    b5_rows = b5_table(grouped_rows, quant_rows)
    b5_s8_rows = b5_s8_table(quant_rows)
    b12_rows = b12_table(timed, quant_rows)
    b12_s8_rows = b12_s8_table(quant_rows)
    f32_rows = f32_table(gen)
    t0 = time.perf_counter()
    sk_errs, sk_cases, sk_bitwise, sk_empty, sk_fault, sk_launches = splitk_sweep(gen)
    log(f"B6 sweep {SPLITK_SHAPES} x {[p[0] for p in SPLITK_PAIRS]} x s {SPLITK_S} x g "
        f"{SPLITK_G}: {sk_cases} cases agree with the plain version and the reference; max "
        f"errors {sk_errs}; {sk_bitwise} bitwise repeats; {sk_empty} cases with empty splits "
        f"read 0; planted fault {sk_fault}; launches by pair {sk_launches} "
        f"({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    log("the baseline comparison at granite-8b's projections (device ms):")
    compare_rows, compare_launches, compare_err = baseline_comparison(gen)
    log("B6 at 4x14336x4096, s = 4, on every operand pair (device ms):")
    splitk_rows = time_splitk(gen)
    timed["splitk_partials"] = next(r for r in splitk_rows if r["pair"] == "bf16")
    batched = batched_check(gen)
    log(f"baseline comparison, B6 timing and gemm_batched ({time.perf_counter() - t0:.1f}s)")
    gc.collect()
    torch.cuda.empty_cache()

    failures = []
    t0 = time.perf_counter()
    paged = {}  # phase 5 (a) runs on phase 3's granite-8b weights, before they are freed

    def paged_granite(model, params, runs):
        paged["granite"] = phase_paged_granite(model, params, runs, failures)

    serve = {"granite-8b": phase_serve("granite-8b", failures, then=paged_granite)}
    log(f"granite-8b served dense and on {list(RUNGS)} ({time.perf_counter() - t0:.1f}s)")
    gc.collect()  # granite's weights go before the next model's arrive
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kv_int8 = phase_kv_int8()
    log(f"int8 KV cache phase ({time.perf_counter() - t0:.1f}s)")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serve["olmoe-1b-7b"] = phase_serve("olmoe-1b-7b", failures)
    log(f"olmoe-1b-7b served dense and on {list(RUNGS)} ({time.perf_counter() - t0:.1f}s)")
    gc.collect()
    torch.cuda.empty_cache()
    tune = phase_tune(failures)
    gc.collect()
    torch.cuda.empty_cache()
    paged = phase_paged(paged["granite"], failures)

    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.common import mainloop

    kernels = []
    for name in SERVED_KERNELS:
        t = timed[name]
        # launches: each kernel's count from the main path that serves it
        arch = "olmoe-1b-7b" if name.startswith("grouped") else "granite-8b"
        other = "granite-8b" if arch != "granite-8b" else "olmoe-1b-7b"
        extra = {key: t[key] for key in ("sweep_shape", "sweep_ms", "sweep_plain_ms",
                                         "library_of", "composed_ms") if key in t}
        # the served models and the timings run bf16 activations
        extra["mainloop"] = mainloop(name, torch.bfloat16)
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=serve[arch]["dense"]["launches"].get(name, 0),
            max_abs_err=t["max_abs_err"], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"], shape=t["shape"], policy=t["policy"], tile=t["tile"],
            g=t["g"], sweep_max_err=errs[name], event_ms=t["event_ms"],
            plain_event_ms=t["plain_event_ms"], library_event_ms=t.get("library_event_ms"),
            launches_in=arch, launches_other_model=serve[other]["dense"]["launches"].get(name, 0),
            **extra,
        ))
    # B6 has no served caller: its launches are those of the baseline comparison, the
    # slice's main path
    t = timed["splitk_partials"]
    kernels.append(dict(
        name="splitk_partials", route="cuda", source=SOURCES["splitk_partials"],
        replaces=REPLACES["splitk_partials"], launches=compare_launches["splitk_partials"],
        max_abs_err=t["max_abs_err"], ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=t["library_ms"], library_of=t["library_of"],
        shape=t["shape"], policy=t["policy"], tile=t["tile"], g=t["g"],
        sweep_max_err=max(v for key, v in sk_errs.items() if key.startswith("splitk_partials")),
        event_ms=t["event_ms"], plain_event_ms=t["plain_event_ms"],
        library_event_ms=t["library_event_ms"], launches_in="the baseline comparison",
        mainloop=t["mainloop"],
    ))
    not_served = []
    for rung, (_, _, pair_source) in RUNGS.items():
        for name in SERVED_KERNELS:
            key = f"{name}[{rung}]"
            # each (kernel, rung) that a served path ran: its count from the model that
            # serves it (granite-8b for B1 and B2, olmoe-1b-7b for B5), else from the other
            arch = "olmoe-1b-7b" if name.startswith("grouped") else "granite-8b"
            other = "granite-8b" if arch != "granite-8b" else "olmoe-1b-7b"
            counts = {a: serve[a][rung]["launches"].get(key, 0) for a in (arch, other)}
            if not counts[arch]:
                arch, other = other, arch
            if not counts[arch]:
                not_served.append(key)
                continue
            t = quant_entry(quant_rows, name, rung)
            kernels.append(dict(
                name=key, route="cuda", source=SOURCES[name], instantiated_in=pair_source,
                replaces=REPLACES[name], launches=counts[arch],
                max_abs_err=t["max_abs_err"], ms=t["ms"], plain_ms=t["plain_ms"],
                bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=t["library_ms"],
                library_of=t["library_of"], shape=t["shape"], policy=t["policy"],
                tile=t["tile"], g=t["g"], event_ms=t["event_ms"],
                plain_event_ms=t["plain_event_ms"], library_event_ms=t["library_event_ms"],
                launches_in=f"{arch} {rung}", launches_other_model=counts[other],
                mainloop=mainloop(name, torch.int8 if RUNGS[rung][1] == 8 else torch.bfloat16),
            ))
    log(f"(kernel, rung) pairs no served path ran (timed and swept, not in the kernels line): "
        f"{not_served}")
    record = dict(card=smi, build_s=build_s,
                  build_source_s=cuda_lib.build_info.get("source_seconds"), kernels=kernels,
                  picks=picks, gemms=gemms, grouped=grouped_rows, quant=quant_rows, serve=serve,
                  splitk_cases=sk_cases, splitk_errs=sk_errs, splitk_bitwise=sk_bitwise,
                  splitk_empty=sk_empty, splitk_fault=sk_fault, splitk_launches=sk_launches,
                  splitk_pairs=splitk_rows, compare=compare_rows,
                  compare_launches=compare_launches, compare_max_err=compare_err,
                  batched=batched,
                  sweep_cases=cases, b5_cases=b5_cases, b5_bitwise=b5_bitwise,
                  quant_cases=q_cases, quant_errs=q_errs, quant_bitwise=q_bitwise,
                  quant_b5_cases=qg_cases, quant_b5_errs=qg_errs, quant_b5_bitwise=qg_bitwise,
                  slice_max_err=slice_err, not_served=not_served, failures=failures,
                  b5_table=b5_rows, b5_s8_table=b5_s8_rows, b12_table=b12_rows,
                  b12_s8_table=b12_s8_rows, f32_table=f32_rows,
                  kv_int8=kv_int8, tune=tune, paged=paged,
                  seconds=time.perf_counter() - t_start)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    log(f"total {record['seconds']:.1f}s")
    if failures:
        for f in failures:
            log("FAILED:", f)
        return 1
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
