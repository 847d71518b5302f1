"""The port's Hopper kernels on the card (marker ``cuda``).

Every test here needs a CUDA device and skips without one: the kernels have
no CPU mode. The file imports neither jax nor ``repro``, so it also runs on
a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version (the one its wrapper
runs on CPU tensors) on the same inputs. Tolerances: 1e-4 for f32 (f32 sums
in another order), 2e-2 for bf16 (one bf16 rounding of the output). The
quantized variants (float x int8, int8 x int8, float x packed int4) keep
those tolerances by activation dtype: the int8 -> f32 widening is exact, and
the int8 x int8 and int8 x int4 MACs sum exact int32 k-steps. B6, the
split-K baseline, is held against its plain version on every operand pair,
split factor and grid size, with bitwise determinism and zeroed empty splits.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.core.gemm import gemm, gemm_batched, gemm_context, gemm_grouped
from repro_torch.core.op import Epilogue
from repro_torch.core.policies import ALL_POLICIES, ALL_SK, DP, HYBRIDS, TileConfig
from repro_torch.core.quant import quantize_activations, quantize_weight
from repro_torch.core.workpart import GemmShape, partition
from repro_torch.kernels import common
from repro_torch.kernels.dp import ops as dp_ops
from repro_torch.kernels.dp.dp_gemm import dp_gemm_region, dp_gemm_region_plain
from repro_torch.kernels.splitk import ops as splitk_ops
from repro_torch.kernels.splitk.splitk_gemm import splitk_partials, splitk_partials_plain
from repro_torch.kernels.streamk import ops
from repro_torch.kernels.streamk.grouped import gemm_grouped_streamk, gemm_grouped_streamk_plain
from repro_torch.kernels.streamk.streamk_gemm import (
    n_contributors,
    range_math,
    streamk_fixup,
    streamk_fixup_plain,
    streamk_phase1,
    streamk_phase1_plain,
)
from repro_torch.models.lm import LM
from repro_torch.serve.engine import ServeConfig, ServeEngine

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(m, n, k, dtype, seed):
    r = np.random.default_rng(seed)
    a = r.normal(size=(m, k)).astype(np.float32)
    b = (r.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    bias = r.normal(size=(n,)).astype(np.float32)
    operand = r.normal(size=(m, n)).astype(np.float32)
    return [torch.from_numpy(x).to(dtype) for x in (a, b, bias, operand)]


def _close(got, want, tol):
    np.testing.assert_allclose(
        got.cpu().to(torch.float32).numpy(), want.cpu().to(torch.float32).numpy(),
        rtol=tol, atol=tol,
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("pol_idx", range(len(ALL_POLICIES)), ids=[p.name for p in ALL_POLICIES])
def test_cuda_kernels_match_plain_versions(cuda_device, pol_idx, dtype):
    ta, tb, tbias, top_ = _inputs(64, 1000, 700, dtype, seed=4)
    for cfg in (TileConfig(8, 128, 128), TileConfig(64, 256, 128), TileConfig(16, 128, 256)):
        for g in (6, 132):
            epi = Epilogue(activation="gelu", bias=True, binary="add")
            kw = dict(policy=ALL_POLICIES[pol_idx], cfg=cfg, g=g, epilogue=epi, out_dtype=dtype)
            want = ops.gemm(ta, tb, bias=tbias, operand=top_, **kw)
            got = ops.gemm(ta.to(cuda_device), tb.to(cuda_device), bias=tbias.to(cuda_device),
                           operand=top_.to(cuda_device), **kw)
            _close(got, want, TOL[dtype])


@pytest.mark.parametrize("pair", ["bf16", "bf16*int8", "bf16*int4", "int8*int8", "int8*int4"])
def test_cuda_streamk_is_bitwise_deterministic(cuda_device, pair):
    """B2 then B3 sum the contributor slots in a fixed order: two runs give
    the same bits, on each rung whose B2 runs a tensor-core mainloop
    (mma_bf16.cuh for bf16 activations, mma_s8.cuh for int8 ones, with
    per-row activation scales and an f32 output)."""
    a, b, _, _ = _inputs(4, 4096, 4096, torch.bfloat16, seed=5)
    kw, out = {}, a.dtype
    if pair != "bf16":
        q = quantize_weight(b.float(), bits=4 if pair.endswith("int4") else 8)
        b, kw = q.values, dict(scale=q.scales.to(cuda_device), b_bits=q.bits)
    if pair.startswith("int8"):
        a, scale_a = quantize_activations(a.float())
        kw["scale_a"], out = scale_a.to(cuda_device), torch.float32
    a, b = a.to(cuda_device), b.to(cuda_device)
    part = partition(GemmShape(4, 4096, 4096), TileConfig(8, 256, 128), 132, ALL_SK)
    assert part.max_contributors > 1
    outs = []
    for _ in range(2):
        c = torch.empty(4, 4096, dtype=out, device=cuda_device)
        p = streamk_phase1(a, b, part, b_bits=kw.get("b_bits", 8))
        outs.append(streamk_fixup(p, part, c, scale=kw.get("scale"),
                                  scale_a=kw.get("scale_a")))
    assert torch.equal(outs[0], outs[1])


def test_cuda_launch_counters_count_each_kernel(cuda_device):
    """A HYBRID partition launches each of B2, B3 and B1 once."""
    a, b, _, _ = (t.to(cuda_device) for t in _inputs(20, 300, 520, torch.float32, seed=6))
    cfg = TileConfig(8, 128, 128)
    part = partition(GemmShape(20, 300, 520), cfg, 4, HYBRIDS[0])
    assert part.sk_tiles and part.dp_tiles
    common.reset_launch_counts()
    with common.count_launches() as log:
        ops.gemm(a, b, policy=HYBRIDS[0], cfg=cfg, g=4)
    assert log == ["streamk_phase1", "streamk_fixup", "dp_gemm_region"]
    assert common.LAUNCHES == dict(dict.fromkeys(common.LAUNCHES, 0), dp_gemm_region=1,
                                   streamk_phase1=1, streamk_fixup=1)
    common.reset_launch_counts()


def test_cuda_dispatch_runs_the_kernels_by_default(cuda_device):
    """``gemm`` on CUDA tensors, with no backend named, runs the
    hand-written kernels (never a library matmul)."""
    a, b, _, _ = (t.to(cuda_device) for t in _inputs(4, 1024, 4096, torch.bfloat16, seed=7))
    with common.count_launches() as log:
        got = gemm(a, b, tag="t")
    assert log, "no kernel launched"
    _close(got, (a.float() @ b.float()).to(a.dtype), TOL[torch.bfloat16])


@pytest.mark.parametrize("kw", [dict(scale=torch.ones(300)), dict(scale_a=torch.ones(20)),
                                dict()], ids=["scale", "scale_a", "int4"])
def test_cuda_wrappers_raise_on_quantized_arguments(cuda_device, kw):
    """int8 activations x packed int4 weights, once refused, launch their
    own instantiations now (counted under int4-dynamic) and give the plain
    versions' result: every packed byte 1 holds k even at 1 and k odd at 0,
    so each output is 260 times the scales."""
    a = torch.ones(20, 520, dtype=torch.int8, device=cuda_device)
    b = torch.ones(260, 300, dtype=torch.int8, device=cuda_device)
    kw = {k: v.to(cuda_device) if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
    want = torch.full((20, 300), 260.0, device=cuda_device)
    for name, v in kw.items():
        want = want * (v[:, None] if name == "scale_a" else v[None, :])
    f32 = dict(out_dtype=torch.float32)
    with common.count_launches() as log:
        got = [ops.gemm(a, b, policy=ALL_SK, cfg=TileConfig(8, 128, 128), g=4, b_bits=4,
                        **f32, **kw),
               dp_gemm_region(a, b, TileConfig(8, 128, 128), b_bits=4, **f32, **kw),
               splitk_ops.gemm(a, b, cfg=TileConfig(8, 128, 128), s=4, b_bits=4, **f32, **kw)]
        grouped = gemm_grouped_streamk(a[None], b[None], cfg=TileConfig(8, 128, 128), b_bits=4,
                                       **f32)
    for c in got:
        assert torch.equal(c, want)
    assert torch.equal(grouped[0], torch.full((20, 300), 260.0, device=cuda_device))
    assert log == ["streamk_phase1[int4-dynamic]", "streamk_fixup[int4-dynamic]",
                   "dp_gemm_region[int4-dynamic]", "splitk_partials[int4-dynamic]",
                   "grouped_streamk_sk[int4-dynamic]"]


def test_cuda_served_tokens_match_torch_backend(cuda_device):
    """Reduced granite-8b in f32 on the card: the engine on the kernels and
    the engine on library matmuls emit the same greedy tokens."""
    cfg = dataclasses.replace(get_reduced("granite-8b"), dtype="float32")
    model = LM(cfg)
    params = model.init_params(cuda_device, torch.Generator(device=cuda_device).manual_seed(0))
    prompts = [np.array(p, np.int32) for p in ([5, 17, 3, 99, 42, 7], [200, 1, 64])]
    tokens = {}
    for backend in ("cuda", "torch"):
        engine = ServeEngine(model, params, ServeConfig(n_slots=2, max_seq=32, eos=-1),
                             backend=backend, device=cuda_device)
        for p in prompts:
            engine.submit(p, max_new_tokens=6)
        tokens[backend] = {r.uid: r.out_tokens for r in engine.run()}
    assert tokens["cuda"] == tokens["torch"] and len(tokens["cuda"]) == 2


# ---------------------------------------------------------------------------
# B5: the grouped kernel
# ---------------------------------------------------------------------------


def _grouped_inputs(g, m, n, k, dtype, seed):
    r = np.random.default_rng(seed)
    a = r.normal(size=(g, m, k)).astype(np.float32)
    b = (r.normal(size=(g, k, n)) / np.sqrt(k)).astype(np.float32)
    bias = r.normal(size=(g, n)).astype(np.float32)
    operand = r.normal(size=(g, m, n)).astype(np.float32)
    return [torch.from_numpy(x).to(dtype) for x in (a, b, bias, operand)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("pol_idx", range(len(ALL_POLICIES)), ids=[p.name for p in ALL_POLICIES])
def test_cuda_grouped_matches_plain_version(cuda_device, pol_idx, dtype):
    """Both forms, ragged sizes with an empty group, rows that are and are
    not 16-byte aligned, every epilogue stage, g from 6 to 264."""
    for (g_count, m, n, k), sizes in (((5, 20, 302, 200), (17, 0, 20, 3, 9)),
                                      ((4, 16, 384, 512), (16, 16, 16, 16))):
        ta, tb, tbias, top_ = _grouped_inputs(g_count, m, n, k, dtype, seed=8)
        for cfg in (TileConfig(8, 128, 128), TileConfig(16, 256, 128)):
            for g in (6, 132, 264):
                for epi, kw in ((Epilogue(activation="gelu", bias=True), dict(bias=tbias)),
                                (Epilogue(binary="mul_silu"), dict(operand=top_))):
                    want = gemm_grouped_streamk_plain(ta, tb, sizes=sizes, out_dtype=dtype,
                                                      epilogue=epi, **kw)
                    got = gemm_grouped_streamk(
                        ta.to(cuda_device), tb.to(cuda_device), policy=ALL_POLICIES[pol_idx],
                        cfg=cfg, g=g, out_dtype=dtype, epilogue=epi, group_sizes=sizes,
                        **{key: v.to(cuda_device) for key, v in kw.items()})
                    _close(got, want, TOL[dtype])
                    for i, s_ in enumerate(sizes):
                        assert not got[i, s_:].any()


@pytest.mark.parametrize("pair", ["bf16", "int8*int8", "int8*int4"])
def test_cuda_grouped_streamk_is_bitwise_deterministic(cuda_device, pair):
    """The olmoe prefill shape under ALL_SK splits tiles between blocks; the
    last contributor sums the slots in a fixed order: two runs, same bits.
    bf16 runs the tensor-core mainloop of mma_bf16.cuh, the int8-activation
    pairs (int8 or packed int4 weights, per-expert and per-row scales) that
    of mma_s8.cuh."""
    a, b, _, _ = _grouped_inputs(64, 16, 1024, 2048, torch.bfloat16, seed=9)
    kw, out, tol = {}, torch.bfloat16, TOL[torch.bfloat16]
    if pair != "bf16":
        bits = 8 if pair == "int8*int8" else 4
        q = quantize_weight(b.float(), bits=bits)
        a, scale_a = quantize_activations(a.float())
        b, kw, out, tol = q.values, dict(scale=q.scales, scale_a=scale_a, b_bits=bits), \
            torch.float32, TOL[torch.float32]
    cfg = TileConfig(16, 128, 128)
    ipt, total = 2048 // 128, 64 * 8 * (2048 // 128)
    assert (-(-total // 132)) % ipt  # a workgroup boundary falls inside a tile
    da, db, dkw = a.to(cuda_device), b.to(cuda_device), _to(kw, cuda_device)
    outs = [gemm_grouped_streamk(da, db, policy=ALL_SK, cfg=cfg, g=132, out_dtype=out, **dkw)
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    _close(outs[0], gemm_grouped_streamk_plain(a, b, sizes=(16,) * 64, out_dtype=out, **kw),
           tol)


def test_cuda_fused_grouped_dispatch_launches_once(cuda_device):
    """One fused grouped dispatch is one launch of B5; the loop form is one
    DP launch per group. With no live row nothing launches."""
    x, w, _, _ = (t.to(cuda_device) for t in _grouped_inputs(6, 8, 256, 128, torch.float32,
                                                               seed=10))
    kw = dict(policy=DP, cfg=TileConfig(8, 128, 128), grid=4)
    with common.count_launches() as fused:
        got = gemm_grouped(x, w, **kw)
    with common.count_launches() as loop:
        want = gemm_grouped(x, w, fused=False, **kw)
    assert fused == ["grouped_streamk_dp"]
    assert loop == ["dp_gemm_region"] * 6
    _close(got, want, TOL[torch.float32])
    with common.count_launches() as none:
        out = gemm_grouped_streamk(x, w, cfg=TileConfig(8, 128, 128), group_sizes=(0,) * 6)
    assert none == [] and not out.any()


def test_cuda_moe_served_tokens_match_torch_backend(cuda_device):
    """Reduced olmoe-1b-7b in f32 on the card: the engine on the kernels and
    the engine on library matmuls emit the same greedy tokens."""
    cfg = dataclasses.replace(get_reduced("olmoe-1b-7b"), dtype="float32")
    model = LM(cfg)
    params = model.init_params(cuda_device, torch.Generator(device=cuda_device).manual_seed(0))
    prompts = [np.array(p, np.int32) for p in ([5, 17, 3, 99, 42, 7], [200, 1, 64])]
    tokens = {}
    for backend in ("cuda", "torch"):
        engine = ServeEngine(model, params, ServeConfig(n_slots=2, max_seq=32, eos=-1),
                             backend=backend, device=cuda_device)
        for p in prompts:
            engine.submit(p, max_new_tokens=6)
        with common.count_launches() as log:
            tokens[backend] = {r.uid: r.out_tokens for r in engine.run()}
        if backend == "cuda":
            assert {"grouped_streamk_sk", "grouped_streamk_dp"} & set(log)
    assert tokens["cuda"] == tokens["torch"] and len(tokens["cuda"]) == 2


# ---------------------------------------------------------------------------
# B5's tensor-core mainloop (csrc/mma_bf16.cuh): the bf16-activation rungs
# ---------------------------------------------------------------------------

#: the pairs that run mma_subblock: bf16 activations x bf16, int8 or packed int4 weights
MMA_BITS = {"bf16": None, "bf16*int8": 8, "bf16*int4": 4}
#: (G, M, N, K): aligned rows; K odd and N not a multiple of 16, so neither
#: A's nor B's rows are 16-byte aligned (the element-wise staging path, an odd
#: K for packed int4); and a K that ends inside a 64-deep chunk
MMA_SHAPES = ((5, 64, 384, 1024), (5, 64, 302, 203), (4, 64, 256, 331))


def _mma_operands(g, m, n, k, bits, seed):
    r = np.random.default_rng(seed)
    a = torch.from_numpy(r.normal(size=(g, m, k)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((r.normal(size=(g, k, n)) / np.sqrt(k)).astype(np.float32))
    bias = torch.from_numpy(r.normal(size=(g, n)).astype(np.float32)).to(torch.bfloat16)
    operand = torch.from_numpy(r.normal(size=(g, m, n)).astype(np.float32)).to(torch.bfloat16)
    if bits is None:
        return a, w.to(torch.bfloat16), {}, bias, operand
    q = quantize_weight(w, bits=bits)
    return a, q.values, dict(scale=q.scales, b_bits=bits), bias, operand


@pytest.mark.parametrize("pair", list(MMA_BITS))
@pytest.mark.parametrize("bm", [8, 16, 32, 64], ids=lambda bm: f"sm{bm}")
def test_cuda_grouped_mma_mainloop_matches_plain_version(cuda_device, bm, pair):
    """Both B5 forms on the tensor-core mainloop, at sub-block rows SM = bm
    (M = 64 lets ``sub_block_rows`` take each of 8, 16, 32 and 64), bn 128
    and 256, full and ragged group sizes with an empty group, the bias and
    residual epilogue, against the plain version (2e-2, one bf16 rounding of
    the output). Every call runs twice and the two outputs are bitwise
    identical; some Stream-K case splits a tile."""
    assert common.sub_block_rows(bm, 64) == bm
    split = 0
    for gm, m, n, k in MMA_SHAPES:
        a, b, kw, bias, operand = _mma_operands(gm, m, n, k, MMA_BITS[pair], seed=bm + n)
        dev = {key: v.to(cuda_device) if torch.is_tensor(v) else v for key, v in kw.items()}
        for bn in (128, 256):
            cfg = TileConfig(bm, bn, 128)
            for sizes, epi, ekw in (((m,) * gm, Epilogue(), {}),
                                    ((0, m, 7, 33, 1)[:gm], Epilogue(bias=True, binary="add"),
                                     dict(bias=bias, operand=operand))):
                want = gemm_grouped_streamk_plain(a, b, sizes=sizes, out_dtype=torch.bfloat16,
                                                  epilogue=epi, **kw, **ekw)
                dev_e = {key: v.to(cuda_device) for key, v in ekw.items()}
                for pol, g in ((DP, 132), (ALL_SK, 7), (ALL_SK, 132), (ALL_SK, 264)):
                    run = [gemm_grouped_streamk(
                        a.to(cuda_device), b.to(cuda_device), policy=pol, cfg=cfg, g=g,
                        out_dtype=torch.bfloat16, epilogue=epi, group_sizes=sizes, **dev,
                        **dev_e) for _ in range(2)]
                    assert torch.equal(run[0], run[1]), (pair, bm, bn, pol.name, g, sizes)
                    _close(run[0], want, TOL[torch.bfloat16])
                    for i, s_ in enumerate(sizes):
                        assert not run[0][i, s_:].any()
                    tiles = sum(-(-s_ // bm) for s_ in sizes) * -(-n // bn)
                    ipt = -(-k // 128)
                    ipw = -(-tiles * ipt // g)
                    split += pol is ALL_SK and tiles * ipt > ipw and ipw % ipt != 0
    assert split, "no Stream-K case split a tile"


# ---------------------------------------------------------------------------
# B5's s8 tensor-core mainloop (csrc/mma_s8.cuh): the int8-activation rungs
# ---------------------------------------------------------------------------

#: the pairs that run mma_s8_subblock: int8 activations x int8 or packed int4 weights
S8_BITS = {"int8*int8": 8, "int8*int4": 4}
#: (G, M, N, K): aligned rows and a K that ends inside a 256-deep chunk; K
#: odd and N not a multiple of 16, so neither A's nor B's rows are 16-byte
#: aligned (the element-wise staging path, an odd K for packed int4); and a
#: K ragged against 32, 128 and 256
S8_SHAPES = ((5, 64, 384, 1152), (5, 64, 302, 203), (4, 64, 256, 331))
#: (epilogue, output dtype, what it reads besides the two scales): the
#: scales alone, then every stage, scale_a -> scale -> bias -> activation ->
#: binary, in two variants
S8_EPILOGUES = ((Epilogue(), ()),
                (Epilogue(activation="gelu", bias=True, binary="add"), ("bias", "operand")),
                (Epilogue(activation="silu", bias=True, binary="mul_silu"), ("bias", "operand")))


def _grouped_segment_starts(n_tiles, ipt, g):
    """The k-iteration offset within its tile at which each segment of the
    grouped Stream-K form starts (blocks walk ``ceil(T * ipt / g)``
    iterations each)."""
    total = n_tiles * ipt
    ipw = -(-total // g)
    starts = []
    for x in range(g):
        it, end = x * ipw, min(total, (x + 1) * ipw)
        while it < end:
            starts.append(it % ipt)
            it = min(end, (it // ipt + 1) * ipt)
    return starts


@pytest.mark.parametrize("pair", list(S8_BITS))
@pytest.mark.parametrize("bm", [8, 16, 32, 64], ids=lambda bm: f"sm{bm}")
def test_cuda_grouped_s8_mainloop_matches_plain_version(cuda_device, bm, pair):
    """Both B5 forms on the s8 tensor-core mainloop, at sub-block rows
    SM = bm (M = 64 lets ``sub_block_rows`` take each of 8, 16, 32 and 64),
    bn 128 and 256, bk 128 and 256, full and ragged group sizes with an empty
    group, per-expert and per-row scales and every epilogue stage, f32
    output, against the plain version at 1e-4 x max|ref|; ALL_SK at g 7,
    132 and one whose segments start at odd multiples of bk = 128 (inside
    int4's 256-deep chunk). Each bk step's int32 sum enters the f32 sum in
    order, as ``kstep_dot`` adds them, so with the scales alone the DP form
    equals the plain version bit for bit; every call runs twice with the
    same bits."""
    bits = S8_BITS[pair]
    assert common.sub_block_rows(bm, 64) == bm
    odd_starts = split = 0
    for gm, m, n, k in S8_SHAPES:
        r = np.random.default_rng(bm + n + k)
        a, scale_a = quantize_activations(
            torch.from_numpy(r.normal(size=(gm, m, k)).astype(np.float32)))
        q = quantize_weight(torch.from_numpy(
            (r.normal(size=(gm, k, n)) / np.sqrt(k)).astype(np.float32)), bits=bits)
        bias = torch.from_numpy(r.normal(size=(gm, n)).astype(np.float32))
        operand = torch.from_numpy(r.normal(size=(gm, m, n)).astype(np.float32))
        qkw = dict(scale=q.scales, scale_a=scale_a, b_bits=bits)
        da, db, dq = a.to(cuda_device), q.values.to(cuda_device), _to(qkw, cuda_device)
        for bn in (128, 256):
            for bk in (128, 256):
                cfg = TileConfig(bm, bn, bk)
                for sizes in ((m,) * gm, (0, m, 7, 33, 1)[:gm]):
                    for epi, reads in S8_EPILOGUES:
                        ekw = {key: v for key, v in (("bias", bias), ("operand", operand))
                               if key in reads}
                        want = gemm_grouped_streamk_plain(
                            a, q.values, sizes=sizes, out_dtype=torch.float32, epilogue=epi,
                            bk=bk, **qkw, **ekw)
                        dev_e = _to(ekw, cuda_device)
                        n_tiles = sum(-(-s_ // bm) for s_ in sizes) * -(-n // bn)
                        ipt = -(-k // bk)
                        odd_g = -(-n_tiles * ipt // 3)
                        for pol, g in ((DP, 132), (ALL_SK, 7), (ALL_SK, 132), (ALL_SK, odd_g)):
                            what = (pair, bm, gm, m, n, k, cfg.name, sizes, epi.name, pol.name, g)
                            run = [gemm_grouped_streamk(
                                da, db, policy=pol, cfg=cfg, g=g, out_dtype=torch.float32,
                                epilogue=epi, group_sizes=sizes, **dq, **dev_e)
                                for _ in range(2)]
                            assert torch.equal(run[0], run[1]), what
                            _close_max(run[0], want, 1e-4, what)
                            if pol is DP and not reads:
                                assert torch.equal(run[0].cpu(), want), what
                            for i, s_ in enumerate(sizes):
                                assert not run[0][i, s_:].any(), what
                            if pol is ALL_SK:
                                starts = _grouped_segment_starts(n_tiles, ipt, g)
                                odd_starts += bk == 128 and sum(s_ % 2 for s_ in starts)
                                ipw = -(-n_tiles * ipt // g)
                                split += n_tiles * ipt > ipw and ipw % ipt != 0
    assert odd_starts, "no Stream-K segment started at an odd multiple of bk"
    assert split, "no Stream-K case split a tile"


# B1 and B2 on the same mainloop: each sub-block of dp_kernel and
# streamk_kernel runs mma_subblock on the bf16-activation rungs

#: (M, N, K): aligned rows; M ragged, N not a multiple of 16 and K odd, so
#: neither A's nor B's rows are 16-byte aligned (the element-wise staging
#: path); and a K that ends inside a chunk. M = 64 and 57 both let
#: ``sub_block_rows`` take each of 8, 16, 32 and 64.
MMA_2D_SHAPES = ((64, 384, 1024), (57, 302, 203), (57, 256, 331))
#: (epilogue, which of bias / operand / scale_a it reads): none; and every
#: stage, scale_a -> scale -> bias -> activation -> binary, in two variants
MMA_EPILOGUES = ((Epilogue(), ()),
                 (Epilogue(activation="gelu", bias=True, binary="add"),
                  ("bias", "operand", "scale_a")),
                 (Epilogue(activation="silu", bias=True, binary="mul_silu"),
                  ("bias", "operand", "scale_a")))


def _close_max(got, want, tol, what):
    """max|got - want| <= tol * max(1, max|want|)."""
    got, want = got.cpu().float(), want.cpu().float()
    err = (got - want).abs().max().item()
    assert err <= tol * max(1.0, want.abs().max().item()), (what, err)


def _segment_starts(part):
    """The k-iteration offset within its tile at which each Stream-K
    segment starts."""
    ipt = part.iters_per_tile
    starts = []
    for r in part.sk_ranges:
        it = r.start
        while it < r.end:
            tile = it // ipt
            starts.append(it - tile * ipt)
            it = min(r.end, (tile + 1) * ipt)
    return starts


@pytest.mark.parametrize("pair", list(MMA_BITS))
@pytest.mark.parametrize("bm", [8, 16, 32, 64], ids=lambda bm: f"sm{bm}")
def test_cuda_mma_mainloop_matches_plain_version(cuda_device, bm, pair):
    """B1, and B2 then B3, on the tensor-core mainloop at sub-block rows
    SM = bm, bn 128 and 256, against dp_gemm_region_plain and
    streamk_phase1_plain / streamk_fixup_plain (2e-2 x max|ref|): ragged M,
    N and K, rows that are not 16-byte aligned, every epilogue stage, and
    ALL_SK partitions at g 7, 132 and one whose segments start at odd
    multiples of bk = 128 (inside int4's 256-deep chunk). B2's partials are
    compared on every contributor slot whole, so a sub-block outside C must
    read 0."""
    bits = MMA_BITS[pair]
    odd_starts = 0
    for m, n, k in MMA_2D_SHAPES:
        assert common.sub_block_rows(bm, m) == bm
        ga, gb, gkw, gbias, gop = _mma_operands(1, m, n, k, bits, seed=bm + n + k)
        a, b, bias, operand = ga[0], gb[0], gbias[0], gop[0]
        scale = gkw["scale"][0] if bits else None
        scale_a = torch.from_numpy(
            np.random.default_rng(k).uniform(0.5, 1.5, size=m).astype(np.float32))
        b_bits = bits or 8
        da, db = a.to(cuda_device), b.to(cuda_device)
        for bn in (128, 256):
            cfg = TileConfig(bm, bn, 128)
            for epi, reads in MMA_EPILOGUES:
                ekw = {key: v for key, v in (("bias", bias), ("operand", operand),
                                             ("scale_a", scale_a)) if key in reads}
                ekw["scale"] = scale
                dkw = {key: None if v is None else v.to(cuda_device) for key, v in ekw.items()}
                what = (pair, bm, m, n, k, bn, epi.name)
                # B1 over every tile
                want = dp_gemm_region_plain(a, b, cfg, torch.zeros(m, n, dtype=torch.bfloat16),
                                            epilogue=epi, b_bits=b_bits, **ekw)
                got = dp_gemm_region(da, db, cfg, g=132, out_dtype=torch.bfloat16,
                                     epilogue=epi, b_bits=b_bits, **dkw)
                _close_max(got, want, TOL[torch.bfloat16], ("B1", *what))
                # B2 then B3 under ALL_SK
                tiles = -(-m // bm) * -(-n // bn)
                total = tiles * -(-k // 128)
                for g in (7, 132, -(-total // 3)):
                    part = partition(GemmShape(m, n, k), cfg, g, ALL_SK)
                    odd_starts += sum(s_ % 2 for s_ in _segment_starts(part))
                    want_p = streamk_phase1_plain(a, b, part, b_bits=b_bits)
                    got_p = streamk_phase1(da, db, part, b_bits=b_bits)
                    used = (torch.arange(range_math(part)[3] + 1)[None, :]
                            < n_contributors(part)[:, None])
                    _close_max(got_p.cpu()[used], want_p[used], TOL[torch.bfloat16],
                               ("B2", g, *what))
                    want_c = streamk_fixup_plain(
                        want_p, part, torch.zeros(m, n, dtype=torch.bfloat16), epilogue=epi,
                        **ekw)
                    got_c = streamk_fixup(got_p, part, torch.zeros(
                        m, n, dtype=torch.bfloat16, device=cuda_device), epilogue=epi, **dkw)
                    _close_max(got_c, want_c, TOL[torch.bfloat16], ("B2+B3", g, *what))
    assert odd_starts, "no Stream-K segment started at an odd multiple of bk"


# B1 and B2 on the s8 mainloop: dp_s8_kernel and streamk_kernel's int8 branch
# run mma_s8_subblock on the int8-activation rungs

#: (M, N, K): aligned rows and a K that ends inside a 256-deep chunk; M
#: ragged, N not a multiple of 16 and K odd, so neither A's nor B's rows are
#: 16-byte aligned (the element-wise staging path, an odd K for packed
#: int4); and a K ragged against 32, 128 and 256. M = 64 and 57 both let
#: ``sub_block_rows`` take each of 8, 16, 32 and 64.
S8_2D_SHAPES = ((64, 384, 1152), (57, 302, 203), (57, 256, 331))


@pytest.mark.parametrize("pair", list(S8_BITS))
@pytest.mark.parametrize("bm", [8, 16, 32, 64], ids=lambda bm: f"sm{bm}")
def test_cuda_s8_mainloop_matches_plain_version(cuda_device, bm, pair):
    """B1, and B2 then B3, on the s8 tensor-core mainloop at sub-block rows
    SM = bm, bn 128 and 256, bk 128 and 256, against dp_gemm_region_plain
    and streamk_phase1_plain / streamk_fixup_plain: ragged M, N and K, odd K,
    rows that are not 16-byte aligned, per-row and per-column scales with
    every epilogue stage, f32 output, and ALL_SK partitions at g 7, 132 and
    one whose segments start at odd multiples of bk = 128 (inside int4's
    256-deep chunk). Each bk step's int32 sum enters the f32 sum in order,
    as ``kstep_dot`` adds them, so B1 with the scales alone and B2's
    partials (every contributor slot whole, so a sub-block outside C must
    read 0) equal the plain versions bit for bit; the full epilogue is held
    at 1e-4 x max|ref|."""
    bits = S8_BITS[pair]
    odd_starts = 0
    for m, n, k in S8_2D_SHAPES:
        assert common.sub_block_rows(bm, m) == bm
        r = np.random.default_rng(bm + n + k)
        a, scale_a = quantize_activations(
            torch.from_numpy(r.normal(size=(m, k)).astype(np.float32)))
        q = quantize_weight(torch.from_numpy(
            (r.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)), bits=bits)
        bias = torch.from_numpy(r.normal(size=(n,)).astype(np.float32))
        operand = torch.from_numpy(r.normal(size=(m, n)).astype(np.float32))
        scales = dict(scale=q.scales, scale_a=scale_a)
        da, db = a.to(cuda_device), q.values.to(cuda_device)
        for bn in (128, 256):
            for bk in (128, 256):
                cfg = TileConfig(bm, bn, bk)
                total = -(-m // bm) * -(-n // bn) * -(-k // bk)
                parts = []
                for g in (7, 132, -(-total // 3)):
                    part = partition(GemmShape(m, n, k), cfg, g, ALL_SK)
                    starts = _segment_starts(part)
                    odd_starts += bk == 128 and sum(s_ % 2 for s_ in starts)
                    # B2's partials: every contributor slot whole, bit for bit
                    want_p = streamk_phase1_plain(a, q.values, part, b_bits=bits)
                    got_p = streamk_phase1(da, db, part, b_bits=bits)
                    used = (torch.arange(range_math(part)[3] + 1)[None, :]
                            < n_contributors(part)[:, None])
                    assert torch.equal(got_p.cpu()[used], want_p[used]), (pair, bm, m, n, k,
                                                                           cfg.name, g)
                    parts.append((g, part, want_p, got_p))
                for epi, reads in S8_EPILOGUES:
                    ekw = dict(scales, **{key: v for key, v in (("bias", bias),
                                                                ("operand", operand))
                                          if key in reads})
                    dkw = _to(ekw, cuda_device)
                    what = (pair, bm, m, n, k, cfg.name, epi.name)
                    # B1 over every tile
                    want = dp_gemm_region_plain(a, q.values, cfg, torch.zeros(m, n),
                                                epilogue=epi, b_bits=bits, **ekw)
                    got = dp_gemm_region(da, db, cfg, g=132, out_dtype=torch.float32,
                                         epilogue=epi, b_bits=bits, **dkw)
                    _close_max(got, want, 1e-4, ("B1", *what))
                    if not reads:
                        assert torch.equal(got.cpu(), want), ("B1", *what)
                    # B3 over B2's partials
                    for g, part, want_p, got_p in parts:
                        want_c = streamk_fixup_plain(want_p, part, torch.zeros(m, n),
                                                     epilogue=epi, **ekw)
                        got_c = streamk_fixup(got_p, part, torch.zeros(m, n, device=cuda_device),
                                              epilogue=epi, **dkw)
                        _close_max(got_c, want_c, 1e-4, ("B2+B3", g, *what))
    assert odd_starts, "no Stream-K segment started at an odd multiple of bk"


def test_cuda_int8_kv_cache_decode_logits_match_torch_backend(cuda_device):
    """granite-8b at full width and 2 layers with the int8 KV cache, bf16:
    prefill and two decode steps on the kernels stay within LOGITS_TOL
    (3e-2 x max|logit|, the served limit of granite-8b) of the torch
    backend, and the cache is int8 with f32 scales."""
    cfg = dataclasses.replace(get_config("granite-8b"), n_layers=2, kv_cache_dtype="int8")
    model = LM(cfg)
    params = model.init_params(cuda_device, torch.Generator(device=cuda_device).manual_seed(0))
    prompt = torch.from_numpy(np.random.default_rng(0).integers(1, cfg.vocab_size, 40))
    logits = {}
    for backend in ("cuda", "torch"):
        with gemm_context(backend=backend, device=cuda_device):
            out, cache = model.prefill(params, prompt[None].to(cuda_device), max_seq=64)
            steps = [out]
            pos = torch.tensor([len(prompt)], device=cuda_device)
            for _ in range(2):
                tok = steps[-1][:, -1].argmax(-1, keepdim=True)
                out, cache = model.decode_step(params, cache, tok, pos)
                steps.append(out)
                pos = pos + 1
        assert cache["attn"]["k"].dtype == torch.int8
        assert cache["attn"]["v_scale"].dtype == torch.float32
        logits[backend] = steps
    for got, want in zip(logits["cuda"], logits["torch"]):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 3e-2 * want.float().abs().max().item()


# ---------------------------------------------------------------------------
# the quantization ladder: B1-B3 and B5 on int8 and packed int4 weights
# ---------------------------------------------------------------------------

#: rung -> (activation dtype, weight bits, int8 activations)
RUNGS = {"f32*int8": (torch.float32, 8, False), "bf16*int8": (torch.bfloat16, 8, False),
         "int8*int8": (torch.float32, 8, True), "f32*int4": (torch.float32, 4, False),
         "bf16*int4": (torch.bfloat16, 4, False), "int8*int4": (torch.float32, 4, True)}


def _ladder(m, n, k, rung, seed, lead=()):
    """(a, b, kwargs, tol) of one rung: the weight quantized per output
    channel; int8 activations quantized per row with their scales."""
    act, bits, act_q = RUNGS[rung]
    r = np.random.default_rng(seed)
    a = torch.from_numpy(r.normal(size=(*lead, m, k)).astype(np.float32)).to(act)
    w = quantize_weight(torch.from_numpy(r.normal(size=(*lead, k, n)).astype(np.float32)),
                        bits=bits)
    kw = dict(scale=w.scales, b_bits=bits)
    if act_q:
        a, kw["scale_a"] = quantize_activations(a)
    return a, w.values, kw, TOL[act]


def _to(kw, device):
    return {k: v.to(device) if isinstance(v, torch.Tensor) else v for k, v in kw.items()}


@pytest.mark.parametrize("rung", list(RUNGS))
@pytest.mark.parametrize("pol_idx", range(len(ALL_POLICIES)), ids=[p.name for p in ALL_POLICIES])
def test_cuda_quantized_kernels_match_plain_versions(cuda_device, pol_idx, rung):
    """B1-B3 on every rung: aligned rows (cp.async) and unaligned ones
    (element-wise staging; for int8 B, N not a multiple of 16), odd K and
    K ragged against bk,
    g from 6 to 132, the dequant stages ahead of bias+gelu+residual."""
    for (m, n, k), cfg in (((64, 1024, 704), TileConfig(8, 128, 128)),
                           ((20, 302, 331), TileConfig(16, 256, 128)),
                           ((33, 384, 520), TileConfig(16, 128, 256))):
        a, b, qkw, tol = _ladder(m, n, k, rung, seed=12)
        r = np.random.default_rng(13)
        bias = torch.from_numpy(r.normal(size=(n,)).astype(np.float32))
        operand = torch.from_numpy(r.normal(size=(m, n)).astype(np.float32))
        out = torch.bfloat16 if a.dtype == torch.bfloat16 else torch.float32
        bias, operand = bias.to(out), operand.to(out)
        for g in (6, 132):
            kw = dict(policy=ALL_POLICIES[pol_idx], cfg=cfg, g=g, out_dtype=out,
                      epilogue=Epilogue(activation="gelu", bias=True, binary="add"), **qkw)
            want = ops.gemm(a, b, bias=bias, operand=operand, **kw)
            got = ops.gemm(a.to(cuda_device), b.to(cuda_device), bias=bias.to(cuda_device),
                           operand=operand.to(cuda_device), **_to(kw, cuda_device))
            _close(got, want, tol)


@pytest.mark.parametrize("rung", list(RUNGS))
def test_cuda_quantized_streamk_is_bitwise_deterministic(cuda_device, rung):
    """B2 then B3 on each rung, and B5's Stream-K form with split tiles:
    two runs give the same bits, and they match the plain versions."""
    a, b, kw, tol = (_ladder(4, 4096, 4096, rung, seed=14))
    a, b, kw = a.to(cuda_device), b.to(cuda_device), _to(kw, cuda_device)
    part = partition(GemmShape(4, 4096, 4096), TileConfig(8, 256, 128), 132, ALL_SK)
    assert part.max_contributors > 1
    out = torch.float32
    runs = [ops.gemm(a, b, policy=ALL_SK, cfg=TileConfig(8, 256, 128), g=132, out_dtype=out,
                     **kw) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    _close(runs[0], ops.gemm(a.cpu(), b.cpu(), policy=ALL_SK, cfg=TileConfig(8, 256, 128),
                             g=132, out_dtype=out, **_to(kw, "cpu")), tol)
    ga, gb, gkw, _ = _ladder(16, 1024, 2048, rung, seed=15, lead=(64,))
    ga, gb, gkw = ga.to(cuda_device), gb.to(cuda_device), _to(gkw, cuda_device)
    cfg = TileConfig(16, 128, 128)
    assert (-(-(64 * 8 * 16) // 132)) % 16  # a workgroup boundary falls inside a tile
    outs = [gemm_grouped_streamk(ga, gb, policy=ALL_SK, cfg=cfg, g=132, out_dtype=out, **gkw)
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("rung", list(RUNGS))
@pytest.mark.parametrize("pol_idx", [0, 1, 2], ids=["dp", "all_sk", "sk1dp"])
def test_cuda_quantized_grouped_matches_plain_version(cuda_device, pol_idx, rung):
    """Both B5 forms on every rung: ragged sizes with an empty group, rows
    that are and are not 16-byte aligned, odd K, the per-expert scales and
    per-row activation scales, g from 6 to 264."""
    for (g_count, m, n, k), sizes in (((5, 20, 302, 201), (17, 0, 20, 3, 9)),
                                      ((4, 16, 384, 512), (16, 16, 16, 16))):
        a, b, qkw, tol = _ladder(m, n, k, rung, seed=16, lead=(g_count,))
        out = torch.bfloat16 if a.dtype == torch.bfloat16 else torch.float32
        operand = torch.from_numpy(
            np.random.default_rng(17).normal(size=(g_count, m, n)).astype(np.float32)).to(out)
        for cfg in (TileConfig(8, 128, 128), TileConfig(16, 256, 128)):
            for g in (6, 132, 264):
                kw = dict(out_dtype=out, epilogue=Epilogue(binary="mul_silu"), **qkw)
                want = gemm_grouped_streamk_plain(a, b, sizes=sizes, operand=operand,
                                                  bk=cfg.bk, **kw)
                got = gemm_grouped_streamk(a.to(cuda_device), b.to(cuda_device),
                                           policy=ALL_POLICIES[pol_idx], cfg=cfg, g=g,
                                           group_sizes=sizes, operand=operand.to(cuda_device),
                                           **_to(kw, cuda_device))
                _close(got, want, tol)
                for i, s_ in enumerate(sizes):
                    assert not got[i, s_:].any()


@pytest.mark.parametrize("bits,act_bits", [(8, None), (8, 8), (4, None), (4, 8)],
                         ids=["int8", "int8-dynamic", "int4", "int4-dynamic"])
def test_cuda_quantized_grouped_dispatch_launches_once(cuda_device, bits, act_bits):
    """One fused grouped dispatch of a quantized expert weight is one B5
    launch, counted under its rung; its result matches the torch backend's
    dequantize-free reference."""
    r = np.random.default_rng(18)
    x = torch.from_numpy(r.normal(size=(6, 8, 256)).astype(np.float32)).to(cuda_device)
    w = quantize_weight(torch.from_numpy(r.normal(size=(6, 256, 384)).astype(np.float32))
                        .to(cuda_device), bits=bits, act_bits=act_bits)
    rung = {(8, None): "int8", (8, 8): "int8-dynamic", (4, None): "int4",
            (4, 8): "int4-dynamic"}[bits, act_bits]
    for pol, name in ((DP, "grouped_streamk_dp"), (ALL_SK, "grouped_streamk_sk")):
        with common.count_launches() as log:
            got = gemm_grouped(x, w, policy=pol, cfg=TileConfig(8, 128, 128), grid=4)
        assert log == [f"{name}[{rung}]"]
        with gemm_context(backend="torch"):
            want = gemm_grouped(x, w, policy=pol, cfg=TileConfig(8, 128, 128), grid=4)
        _close(got, want, TOL[torch.float32])


@pytest.mark.parametrize("quantize", ["int8", "int8-dynamic", "int4"])
@pytest.mark.parametrize("arch", ["granite-8b", "olmoe-1b-7b"])
def test_cuda_quantized_served_tokens_match_torch_backend(cuda_device, arch, quantize):
    """Reduced models in f32 on the card, quantized: the engine on the
    kernels and the engine on the torch backend emit the same greedy tokens,
    and the kernels ran on the rung."""
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    model = LM(cfg)
    params = model.init_params(cuda_device, torch.Generator(device=cuda_device).manual_seed(0))
    params, n, _ = model.quantize_weights(params, bits=4 if quantize == "int4" else 8,
                                          act_bits=8 if quantize == "int8-dynamic" else None)
    assert n > 0
    prompts = [np.array(p, np.int32) for p in ([5, 17, 3, 99, 42, 7], [200, 1, 64])]
    tokens = {}
    for backend in ("cuda", "torch"):
        engine = ServeEngine(model, params, ServeConfig(n_slots=2, max_seq=32, eos=-1),
                             backend=backend, device=cuda_device)
        for p in prompts:
            engine.submit(p, max_new_tokens=6)
        with common.count_launches() as log:
            tokens[backend] = {r.uid: r.out_tokens for r in engine.run()}
        if backend == "cuda":
            assert any(name.endswith(f"[{quantize}]") for name in log)
    assert tokens["cuda"] == tokens["torch"] and len(tokens["cuda"]) == 2


# ---------------------------------------------------------------------------
# B6: the split-K baseline, and the DP baseline and gemm_batched on the card
# ---------------------------------------------------------------------------

#: every operand pair B6 is built for: the dense ones and the ladder's
SPLITK_PAIRS = ["f32", "bf16", *RUNGS]


def _pair(m, n, k, pair, seed):
    if pair in ("f32", "bf16"):
        dtype = torch.float32 if pair == "f32" else torch.bfloat16
        ta, tb, _, _ = _inputs(m, n, k, dtype, seed)
        return ta, tb, {}, TOL[dtype]
    return _ladder(m, n, k, pair, seed)


@pytest.mark.parametrize("pair", SPLITK_PAIRS)
def test_cuda_splitk_matches_plain_version(cuda_device, pair):
    """B6's partials against the plain version on every pair, s in
    {1, 2, 4, 8}, g in {0, 3, 132}: aligned rows (cp.async) and unaligned
    ones with an odd K, and K < bk * s (empty splits, which must read 0
    though the partials come from torch.empty). ops.gemm against the plain
    path on the CPU; two runs bitwise identical. A quantized pair's
    partials are unscaled sums of int8 or int4 codes (hundreds to
    thousands): they are compared dequantized, times the scales that
    ops.gemm applies after the reduction, as the other quantized tests
    compare the kernels' dequantized output."""
    for (m, n, k), cfg in (((64, 1024, 704), TileConfig(8, 128, 128)),
                           ((20, 302, 331), TileConfig(16, 256, 128)),
                           ((9, 384, 200), TileConfig(8, 128, 128))):
        a, b, qkw, tol = _pair(m, n, k, pair, seed=31)
        bits = qkw.get("b_bits", 8)
        da, db, dkw = a.to(cuda_device), b.to(cuda_device), _to(qkw, cuda_device)
        dequant = torch.ones(m, n)
        if "scale" in qkw:
            dequant = dequant * qkw["scale"][None, :]
        if "scale_a" in qkw:
            dequant = dequant * qkw["scale_a"][:, None]
        for s in (1, 2, 4, 8):
            want = splitk_partials_plain(a, b, cfg, s, b_bits=bits)
            for g in (0, 3, 132):
                got = splitk_partials(da, db, cfg, s, g=g, b_bits=bits)
                assert tuple(got.shape) == (s, m, n)
                _close(got.cpu() * dequant, want * dequant, tol)
                empty = -(-k // cfg.bk)
                if empty < s:
                    assert not got[empty:].any()
            runs = [splitk_ops.gemm(da, db, cfg=cfg, s=s, g=3, out_dtype=torch.float32, **dkw)
                    for _ in range(2)]
            assert torch.equal(runs[0], runs[1])
            _close(runs[0], splitk_ops.gemm(a, b, cfg=cfg, s=s, out_dtype=torch.float32, **qkw),
                   tol)


#: B6's pairs on a tensor-core mainloop: bf16 activations (mma_subblock) and
#: int8 ones (mma_s8_subblock), as (weight bits or None for bf16, int8 activations)
SPLITK_MMA_PAIRS = {"bf16": (None, False), "bf16*int8": (8, False), "bf16*int4": (4, False),
                    "int8*int8": (8, True), "int8*int4": (4, True)}
#: the s8 test's shapes, and K = 200 below bk * s for s >= 2 (empty splits)
SPLITK_MMA_SHAPES = S8_2D_SHAPES + ((57, 384, 200),)


@pytest.mark.parametrize("pair", list(SPLITK_MMA_PAIRS))
@pytest.mark.parametrize("bm", [8, 16, 32, 64], ids=lambda bm: f"sm{bm}")
def test_cuda_splitk_mma_mainloops_match_plain_version(cuda_device, bm, pair):
    """B6 on the tensor-core mainloops at sub-block rows SM = bm, bn 128 and
    256, bk 128 and 256, s in {1, 2, 4, 8}, g in {0, 3, 132}, against
    splitk_partials_plain: ragged M, N and K, odd K, rows that are not
    16-byte aligned, empty splits (K = 200), and splits that start at odd
    multiples of bk = 128 (inside int4's 256-deep chunk). int8 activations
    add each bk step's exact int32 sum in the plain version's order, so
    their partials are its bits; bf16 ones sum in another order and are
    held at 2e-2 x max|ref| dequantized, as the scales apply after the
    reduction. Empty splits read 0; each call counts one launch of
    splitk_partials on its rung."""
    bits, act_q = SPLITK_MMA_PAIRS[pair]
    odd_starts = empty = 0
    for m, n, k in SPLITK_MMA_SHAPES:
        assert common.sub_block_rows(bm, m) == bm
        r = np.random.default_rng(bm + n + k)
        a = torch.from_numpy(r.normal(size=(m, k)).astype(np.float32))
        w = torch.from_numpy((r.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32))
        dequant = torch.ones(m, n)
        if bits is None:
            a, b = a.to(torch.bfloat16), w.to(torch.bfloat16)
        else:
            q = quantize_weight(w, bits=bits)
            b, dequant = q.values, dequant * q.scales[None, :]
            if act_q:
                a, scale_a = quantize_activations(a)
                dequant = dequant * scale_a[:, None]
            else:
                a = a.to(torch.bfloat16)
        b_bits = bits or 8
        rung = common.launch_name("splitk_partials", common.rung_of(a.dtype, b.dtype, b_bits))
        da, db = a.to(cuda_device), b.to(cuda_device)
        for bk in (128, 256):
            for s in (1, 2, 4, 8):
                want = splitk_partials_plain(a, b, TileConfig(bm, 128, bk), s, b_bits=b_bits)
                kps = -(-(-(-k // bk)) // s)
                first_empty = -(-k // (kps * bk))
                odd_starts += bk == 128 and kps % 2 == 1 and first_empty > 1
                for bn in (128, 256):
                    for g in (0, 3, 132):
                        what = (pair, bm, m, n, k, bn, bk, s, g)
                        with common.count_launches() as log:
                            got = splitk_partials(da, db, TileConfig(bm, bn, bk), s, g=g,
                                                  b_bits=b_bits)
                        assert log == [rung], what
                        assert tuple(got.shape) == (s, m, n), what
                        if act_q:
                            assert torch.equal(got.cpu(), want), what
                        else:
                            _close_max(got.cpu() * dequant, want * dequant, TOL[torch.bfloat16],
                                       what)
                        if first_empty < s:
                            assert not got[first_empty:].any(), what
                            empty += 1
    assert odd_starts, "no split started at an odd multiple of bk = 128"
    assert empty, "no case had an empty split"


def test_cuda_splitk_and_dp_baselines_launch_their_kernels(cuda_device):
    """splitk.ops.gemm is one B6 launch, dp.ops.gemm one B1 launch, each
    counted under its rung; both agree with the f32 reference."""
    a, b, _, _ = (t.to(cuda_device) for t in _inputs(4, 1024, 4096, torch.float32, seed=32))
    want = a @ b
    with common.count_launches() as log:
        got_s = splitk_ops.gemm(a, b, s=4)
        got_d = dp_ops.gemm(a, b)
    assert log == ["splitk_partials", "dp_gemm_region"]
    _close(got_s, want, TOL[torch.float32])
    _close(got_d, want, TOL[torch.float32])


def test_cuda_gemm_batched_runs_the_pick_per_batch_entry(cuda_device):
    """gemm_batched on the cuda backend: the pick's kernels once per batch
    entry (the loop form), the product of torch.bmm."""
    r = np.random.default_rng(33)
    x = torch.from_numpy(r.normal(size=(3, 4, 512)).astype(np.float32)).to(cuda_device)
    w = torch.from_numpy((r.normal(size=(3, 512, 768)) / 20).astype(np.float32)).to(cuda_device)
    with common.count_launches() as log, gemm_context(backend="cuda") as ctx:
        got = gemm_batched(x, w)
    [e] = ctx.log
    assert e.op.kind == "batched" and not e.op.fused
    part = partition(GemmShape(4, 768, 512), e.selection.cfg, e.selection.g, e.selection.policy)
    per_entry = 2 * bool(part.sk_tiles) + bool(part.dp_tiles)
    assert len(log) == 3 * per_entry
    _close(got, torch.bmm(x, w), TOL[torch.float32])
