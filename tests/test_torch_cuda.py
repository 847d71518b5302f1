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
from repro_torch.kernels.dp.dp_gemm import dp_gemm_region, dp_gemm_region_plain, tile_index
from repro_torch.kernels.splitk import ops as splitk_ops
from repro_torch.kernels.splitk.splitk_gemm import splitk_partials, splitk_partials_plain
from repro_torch.kernels.streamk import ops
from repro_torch.kernels.streamk.grouped import gemm_grouped_streamk, gemm_grouped_streamk_plain
from repro_torch.kernels.streamk.streamk_gemm import (
    n_contributors,
    range_math,
    streamk_fixup_plain,
    streamk_phase1_plain,
    streamk_region,
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
    """The fused Stream-K region sums the contributor slots of a split tile
    in a fixed order: two runs give the same bits, on each rung whose B2
    runs a tensor-core mainloop
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
        outs.append(streamk_region(a, b, part, c, b_bits=kw.get("b_bits", 8),
                                   scale=kw.get("scale"), scale_a=kw.get("scale_a")))
    assert torch.equal(outs[0], outs[1])


def test_cuda_launch_counters_count_each_kernel(cuda_device):
    """A HYBRID partition launches B2 (with B3 fused in) and B1 once each."""
    a, b, _, _ = (t.to(cuda_device) for t in _inputs(20, 300, 520, torch.float32, seed=6))
    cfg = TileConfig(8, 128, 128)
    part = partition(GemmShape(20, 300, 520), cfg, 4, HYBRIDS[0])
    assert part.sk_tiles and part.dp_tiles
    common.reset_launch_counts()
    with common.count_launches() as log:
        ops.gemm(a, b, policy=HYBRIDS[0], cfg=cfg, g=4)
    assert log == ["streamk_phase1", "dp_gemm_region"]
    assert common.LAUNCHES == dict(dict.fromkeys(common.LAUNCHES, 0), dp_gemm_region=1,
                                   streamk_phase1=1)
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
    assert log == ["streamk_phase1[int4-dynamic]",
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


def _split_slots(part):
    """(sk_tiles, mc + 1): the contributor slots of split tiles, below the
    tile's contributor count: those the card defines on every pair (a tile
    that one block owns whole is flushed from registers; dense f32 parks it
    in slot 0 first)."""
    nc = n_contributors(part)
    return (torch.arange(range_math(part)[3] + 1)[None, :] < nc[:, None]) & (nc > 1)[:, None]


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
    """B1, and B2 with B3 fused in, on the tensor-core mainloop at
    sub-block rows SM = bm, bn 128 and 256, against dp_gemm_region_plain
    and streamk_phase1_plain then streamk_fixup_plain (2e-2 x max|ref|):
    ragged M, N and K, rows that are not 16-byte aligned, every epilogue
    stage, and ALL_SK partitions at g 7, 132 and one whose segments start
    at odd multiples of bk = 128 (inside int4's 256-deep chunk). The split
    tiles' partials are compared on every contributor slot whole, so a
    sub-block outside C must read 0; every fused call runs twice with the
    same bytes."""
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
                # B2 with B3 fused in, under ALL_SK
                tiles = -(-m // bm) * -(-n // bn)
                total = tiles * -(-k // 128)
                for g in (7, 132, -(-total // 3)):
                    part = partition(GemmShape(m, n, k), cfg, g, ALL_SK)
                    odd_starts += sum(s_ % 2 for s_ in _segment_starts(part))
                    want_p = streamk_phase1_plain(a, b, part, b_bits=b_bits)
                    run = [streamk_region(da, db, part, torch.zeros(
                        m, n, dtype=torch.bfloat16, device=cuda_device), epilogue=epi,
                        b_bits=b_bits, workspace=True, **dkw) for _ in range(2)]
                    got_c, got_p = run[0]
                    assert torch.equal(got_c, run[1][0]), ("B2+B3", g, *what)
                    used = _split_slots(part)
                    if used.any():
                        _close_max(got_p.cpu()[used], want_p[used], TOL[torch.bfloat16],
                                   ("B2", g, *what))
                    want_c = streamk_fixup_plain(
                        want_p, part, torch.zeros(m, n, dtype=torch.bfloat16), epilogue=epi,
                        **ekw)
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
    """B1, and B2 with B3 fused in, on the s8 tensor-core mainloop at
    sub-block rows SM = bm, bn 128 and 256, bk 128 and 256, against
    dp_gemm_region_plain and streamk_phase1_plain then streamk_fixup_plain:
    ragged M, N and K, odd K, rows that are not 16-byte aligned, per-row and
    per-column scales with every epilogue stage, f32 output, and ALL_SK
    partitions at g 7, 132 and one whose segments start at odd multiples of
    bk = 128 (inside int4's 256-deep chunk). Each bk step's int32 sum enters
    the f32 sum in order, as ``kstep_dot`` adds them, so B1 with the scales
    alone and the split tiles' partials (every contributor slot whole, so a
    sub-block outside C must read 0) equal the plain versions bit for bit;
    the fused C is held at 1e-4 x max|ref|. Every fused call runs twice
    with the same bytes."""
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
                    # the split tiles' partials: every contributor slot whole, bit for bit
                    want_p = streamk_phase1_plain(a, q.values, part, b_bits=bits)
                    _, got_p = streamk_region(da, db, part, torch.zeros(m, n, device=cuda_device),
                                              b_bits=bits, workspace=True,
                                              **_to(scales, cuda_device))
                    used = _split_slots(part)
                    assert torch.equal(got_p.cpu()[used], want_p[used]), (pair, bm, m, n, k,
                                                                           cfg.name, g)
                    parts.append((g, part, want_p))
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
                    # the fused region against the plain composition
                    for g, part, want_p in parts:
                        want_c = streamk_fixup_plain(want_p, part, torch.zeros(m, n),
                                                     epilogue=epi, **ekw)
                        run = [streamk_region(da, db, part, torch.zeros(m, n, device=cuda_device),
                                              epilogue=epi, b_bits=bits, **dkw)
                               for _ in range(2)]
                        assert torch.equal(run[0], run[1]), ("B2+B3", g, *what)
                        _close_max(run[0], want_c, 1e-4, ("B2+B3", g, *what))
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


# ---------------------------------------------------------------------------
# B5's DP form and B6 on the f32 FMA mainloop (csrc/fma_f32.cuh): the
# f32-activation pairs
# ---------------------------------------------------------------------------

#: the pairs that run fma_subblock: f32 activations x f32, int8 or packed int4 weights
FMA_BITS = {"f32": None, "f32*int8": 8, "f32*int4": 4}


def _fma_operands(lead, m, n, k, bits, seed):
    """f32 activations and the pair's weight, from numpy: (a, b, quantized
    kwargs, the dequant row the plain partials are scaled by)."""
    r = np.random.default_rng(seed)
    a = torch.from_numpy(r.normal(size=(*lead, m, k)).astype(np.float32))
    w = torch.from_numpy((r.normal(size=(*lead, k, n)) / np.sqrt(k)).astype(np.float32))
    if bits is None:
        return a, w, {}, torch.ones(n)
    q = quantize_weight(w, bits=bits)
    return a, q.values, dict(scale=q.scales, b_bits=bits), q.scales


@pytest.mark.parametrize("pair", list(FMA_BITS))
@pytest.mark.parametrize("bm", [8, 16, 32, 64], ids=lambda bm: f"sm{bm}")
def test_cuda_fma_mainloop_matches_plain_version(cuda_device, bm, pair):
    """B5's DP form and B6 on the f32 FMA mainloop at sub-block rows SM = bm
    (TN = 4 columns a lane at SM 8-32, 2 at SM = 64), against their plain
    versions at 1e-4 x max|ref| (f32 sums over K slices in another order):
    B5b at MMA_SHAPES with full and ragged group sizes (an empty group),
    bn 128 and 256, bk 128 and 256, g 3 and 132, no epilogue and every stage
    (bias -> activation -> binary; the per-expert scale for int8 and int4);
    B6 at S8_2D_SHAPES and K = 200 (empty splits), bn 128 and 256, bk 128
    and 256, s 1, 2, 4 and 8, g 0, 3 and 132. Both carry ragged M, N and
    K, odd K (int4's zero pad nibble) and rows that are not 16-byte aligned
    (the element-wise staging path). Every call runs twice with the same
    bytes; short groups leave their rows 0, empty splits read 0, and each
    call counts one launch of its kernel on its rung."""
    bits = FMA_BITS[pair]
    b_bits = bits or 8
    assert common.sub_block_rows(bm, 64) == bm
    assert common.mainloop("grouped_streamk_dp", torch.float32) == "fma"
    assert common.mainloop("splitk_partials", torch.float32) == "fma"
    empty = 0
    for gm, m, n, k in MMA_SHAPES:
        a, b, qkw, _ = _fma_operands((gm,), m, n, k, bits, seed=bm + n + k)
        r = np.random.default_rng(bm + k)
        bias = torch.from_numpy(r.normal(size=(gm, n)).astype(np.float32))
        operand = torch.from_numpy(r.normal(size=(gm, m, n)).astype(np.float32))
        da, db, dq = a.to(cuda_device), b.to(cuda_device), _to(qkw, cuda_device)
        rung = common.launch_name("grouped_streamk_dp", common.rung_of(a.dtype, b.dtype, b_bits))
        for sizes in ((m,) * gm, (0, m, 7, 33, 1)[:gm]):
            for epi, reads in S8_EPILOGUES:
                ekw = {key: v for key, v in (("bias", bias), ("operand", operand))
                       if key in reads}
                want = gemm_grouped_streamk_plain(a, b, sizes=sizes, out_dtype=torch.float32,
                                                  epilogue=epi, **qkw, **ekw)
                dev_e = _to(ekw, cuda_device)
                for bn in (128, 256):
                    for bk in (128, 256):
                        for g in (3, 132):
                            what = ("B5b", pair, bm, gm, m, n, k, bn, bk, sizes, epi.name, g)
                            with common.count_launches() as log:
                                run = [gemm_grouped_streamk(
                                    da, db, policy=DP, cfg=TileConfig(bm, bn, bk), g=g,
                                    out_dtype=torch.float32, epilogue=epi, group_sizes=sizes,
                                    **dq, **dev_e) for _ in range(2)]
                            assert log == [rung, rung], what
                            assert torch.equal(run[0], run[1]), what
                            _close_max(run[0], want, 1e-4, what)
                            for i, s_ in enumerate(sizes):
                                assert not run[0][i, s_:].any(), what
    for m, n, k in SPLITK_MMA_SHAPES:
        assert common.sub_block_rows(bm, m) == bm
        a, b, qkw, scale = _fma_operands((), m, n, k, bits, seed=bm + n + k)
        da, db = a.to(cuda_device), b.to(cuda_device)
        rung = common.launch_name("splitk_partials", common.rung_of(a.dtype, b.dtype, b_bits))
        for bk in (128, 256):
            for s in (1, 2, 4, 8):
                want = splitk_partials_plain(a, b, TileConfig(bm, 128, bk), s, b_bits=b_bits)
                kps = -(-(-(-k // bk)) // s)
                first_empty = -(-k // (kps * bk))
                for bn in (128, 256):
                    for g in (0, 3, 132):
                        what = ("B6", pair, bm, m, n, k, bn, bk, s, g)
                        with common.count_launches() as log:
                            run = [splitk_partials(da, db, TileConfig(bm, bn, bk), s, g=g,
                                                   b_bits=b_bits) for _ in range(2)]
                        assert log == [rung, rung], what
                        assert tuple(run[0].shape) == (s, m, n), what
                        assert torch.equal(run[0], run[1]), what
                        _close_max(run[0].cpu() * scale, want * scale, 1e-4, what)
                        if first_empty < s:
                            assert not run[0][first_empty:].any(), what
                            empty += 1
    assert empty, "no case had an empty split"


# B1 and B2 on the f32 FMA mainloop: dp_fma_kernel and streamk_kernel's f32
# branch run fma_subblock on the f32-activation pairs


def _outside_c(part, m, n):
    """(sk_tiles, bm, bn): True where a tile's element lies past M or N."""
    cfg = part.cfg
    t = torch.arange(part.sk_tiles)
    rows = (t // part.n_tiles * cfg.bm)[:, None, None] + torch.arange(cfg.bm)[None, :, None]
    cols = (t % part.n_tiles * cfg.bn)[:, None, None] + torch.arange(cfg.bn)[None, None, :]
    return (rows >= m) | (cols >= n)


def _tile_of(part, m, n):
    """(M, N): each element's Stream-K tile index, -1 outside the region."""
    t = tile_index(m, n, part.cfg, "cpu")
    return torch.where(t < part.sk_tiles, t, -1)


def _k_ordered_phase1(a, b, part):
    """Dense f32 B2's slots as one f32 FMA per k over each segment in
    ascending k, the SIMT loop's order. ``a`` holds signed powers of two, so
    each product is exact and each FMA one rounded f32 addition."""
    cfg = part.cfg
    ipt, _, ipw, mc = range_math(part)
    m, k = a.shape
    n = b.shape[1]
    partials = torch.zeros((part.sk_tiles, mc + 1, cfg.bm, cfg.bn))
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
            prods = a[rows, k0:k1, None] * b[None, k0:k1, cols]
            acc = torch.zeros(prods.shape[0], prods.shape[2])
            for kk in range(k1 - k0):
                acc = acc + prods[:, kk]
            partials[tile, slot, : acc.shape[0], : acc.shape[1]] = acc
            it = seg_end
    return partials


def _close_before_bf16(got, want, tol, what):
    """A bf16 output against the f32 reference: within tol x max(1,
    max|want|) before the one round to nearest bf16 (2^-8 of |x|)."""
    got, want = got.cpu().float(), want.cpu().float()
    near = tol * max(1.0, want.abs().max().item())
    err = (got - want).abs() - (near + want.abs()) * 2.0**-8
    assert (err <= near).all(), (what, err.max().item())


@pytest.mark.parametrize("pair", list(FMA_BITS))
@pytest.mark.parametrize("bm", [8, 16, 32, 64], ids=lambda bm: f"sm{bm}")
def test_cuda_fma_b12_mainloop_matches_plain_version(cuda_device, bm, pair):
    """B1, and B2 with B3 fused in, on the f32 FMA mainloop at sub-block
    rows SM = bm (TN = 4 columns a lane at SM 8-32, 2 at SM = 64), bn 128 and 256, bk
    128 and 256, against their plain versions at 1e-4 x max|ref| (f32 sums
    over K slices in another order): S8_2D_SHAPES, so ragged M, N and K, odd
    K (int4's zero pad nibble) and rows that are not 16-byte aligned (the
    element-wise staging path). B1 with the per-row and per-column scales
    and every epilogue stage, f32 output and bf16 output (the latter within
    1e-4 x max|ref| before its one bf16 rounding); B2 under ALL_SK at g 7,
    132 and one whose segments start at odd multiples of bk = 128 (inside
    int4's 256-deep chunk), the split tiles' partials on every contributor
    slot, where an element or a whole sub-block outside C must read 0, and
    C with every epilogue stage against the plain composition. Every B1 and
    B2 call runs twice with the same bytes and counts one launch of its
    kernel on its rung. Dense f32 B2 (olmoe's router) sums each segment in
    k order, one FMA per k: on activations that are signed powers of two
    its split tiles' partials equal that chain bit for bit, and so do its
    whole tiles, flushed into C."""
    bits = FMA_BITS[pair]
    b_bits = bits or 8
    assert common.mainloop("dp_gemm_region", torch.float32) == "fma"
    assert common.mainloop("streamk_phase1", torch.float32) == "fma"
    odd_starts = outside_sub_blocks = 0
    for m, n, k in S8_2D_SHAPES:
        assert common.sub_block_rows(bm, m) == bm
        a, b, qkw, _ = _fma_operands((), m, n, k, bits, seed=bm + n + k)
        r = np.random.default_rng(k)
        scale_a = torch.from_numpy(r.uniform(0.5, 1.5, size=m).astype(np.float32))
        bias = torch.from_numpy(r.normal(size=(n,)).astype(np.float32))
        operand = torch.from_numpy(r.normal(size=(m, n)).astype(np.float32))
        scale = qkw.get("scale")
        da, db = a.to(cuda_device), b.to(cuda_device)
        rung = common.rung_of(a.dtype, b.dtype, b_bits)
        dp_rung = common.launch_name("dp_gemm_region", rung)
        sk_rung = common.launch_name("streamk_phase1", rung)
        for bn in (128, 256):
            for bk in (128, 256):
                cfg = TileConfig(bm, bn, bk)
                total = -(-m // bm) * -(-n // bn) * -(-k // bk)
                parts = []
                for g in (7, 132, -(-total // 3)):
                    what = ("B2", pair, bm, m, n, k, cfg.name, g)
                    part = partition(GemmShape(m, n, k), cfg, g, ALL_SK)
                    odd_starts += bk == 128 and sum(s_ % 2 for s_ in _segment_starts(part))
                    want_p = streamk_phase1_plain(a, b, part, b_bits=b_bits)
                    with common.count_launches() as log:
                        run = [streamk_region(da, db, part, torch.zeros(m, n, device=cuda_device),
                                              b_bits=b_bits, workspace=True) for _ in range(2)]
                    assert log == [sk_rung, sk_rung], what
                    used = _split_slots(part)
                    got_p = run[0][1].cpu()
                    assert torch.equal(run[0][0], run[1][0]), what
                    assert torch.equal(got_p[used], run[1][1].cpu()[used]), what
                    if used.any():
                        _close_max(got_p[used], want_p[used], 1e-4, what)
                    outside = _outside_c(part, m, n)[:, None].expand_as(got_p)
                    assert not got_p[used[..., None, None].expand_as(got_p) & outside].any(), what
                    outside_sub_blocks += int(bn == 256 and -(-n // 128) % 2
                                              and bool(used.any()))
                    parts.append((g, part, want_p))
                    if bits is None and g == 132:
                        r2 = np.random.default_rng(m + n)
                        a2 = torch.from_numpy((r2.choice([-1.0, 1.0], size=(m, k)) * 2.0
                                               ** r2.integers(-2, 3, size=(m, k)))
                                              .astype(np.float32))
                        c2, got2 = streamk_region(a2.to(cuda_device), db, part,
                                                  torch.zeros(m, n, device=cuda_device),
                                                  workspace=True)
                        want2 = _k_ordered_phase1(a2, b, part)
                        assert torch.equal(got2.cpu()[used], want2[used]), ("k order", *what)
                        # a whole tile's flush is its one slot's k-ordered sum
                        whole = n_contributors(part) == 1
                        want_c2 = streamk_fixup_plain(want2 * whole[:, None, None, None], part,
                                                      torch.zeros(m, n))
                        tile = _tile_of(part, m, n)
                        in_whole = (tile >= 0) & whole[tile.clamp(min=0)]
                        assert torch.equal(c2.cpu()[in_whole], want_c2[in_whole]), (
                            "k order, whole tiles", *what)
                for epi, reads in MMA_EPILOGUES:
                    ekw = {key: v for key, v in (("bias", bias), ("operand", operand),
                                                 ("scale_a", scale_a)) if key in reads}
                    ekw["scale"] = scale
                    what = (pair, bm, m, n, k, cfg.name, epi.name)
                    # B1 over every tile, f32 and bf16 output
                    want = dp_gemm_region_plain(a, b, cfg, torch.zeros(m, n), epilogue=epi,
                                                b_bits=b_bits, **ekw)
                    for out in (torch.float32, torch.bfloat16):
                        okw = {key: v if v is None or key.startswith("scale") else v.to(out)
                               for key, v in ekw.items()}
                        want_o = want if out == torch.float32 else dp_gemm_region_plain(
                            a, b, cfg, torch.zeros(m, n), epilogue=epi, b_bits=b_bits,
                            **{key: v if v is None else v.float() for key, v in okw.items()})
                        with common.count_launches() as log:
                            run = [dp_gemm_region(da, db, cfg, g=132, out_dtype=out,
                                                  epilogue=epi, b_bits=b_bits,
                                                  **_to(okw, cuda_device)) for _ in range(2)]
                        assert log == [dp_rung, dp_rung], ("B1", out, *what)
                        assert run[0].dtype == out and torch.equal(run[0], run[1]), ("B1", *what)
                        if out == torch.float32:
                            _close_max(run[0], want_o, 1e-4, ("B1", out, *what))
                        else:
                            _close_before_bf16(run[0], want_o, 1e-4, ("B1", out, *what))
                    # the fused region against the plain composition
                    for g, part, want_p in parts:
                        want_c = streamk_fixup_plain(want_p, part, torch.zeros(m, n),
                                                     epilogue=epi, **ekw)
                        got_c = streamk_region(da, db, part, torch.zeros(m, n, device=cuda_device),
                                               epilogue=epi, b_bits=b_bits,
                                               **_to(ekw, cuda_device))
                        _close_max(got_c, want_c, 1e-4, ("B2+B3", g, *what))
    assert odd_starts, "no Stream-K segment started at an odd multiple of bk"
    assert outside_sub_blocks, "no case had a sub-block wholly outside C"


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
    per_entry = bool(part.sk_tiles) + bool(part.dp_tiles)
    assert len(log) == 3 * per_entry
    _close(got, torch.bmm(x, w), TOL[torch.float32])


#: the eight operand pairs of the fused Stream-K region: (activations) * (weights)
REGION_PAIRS = ("bf16", "bf16*int8", "bf16*int4", "f32", "f32*int8", "f32*int4",
                "int8*int8", "int8*int4")


def _pair_operands(pair, m, n, k, seed):
    """(a, b, quantized kwargs, output dtype) of one operand pair, from numpy."""
    r = np.random.default_rng(seed)
    a = torch.from_numpy(r.normal(size=(m, k)).astype(np.float32))
    w = torch.from_numpy((r.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32))
    act, _, weights = pair.partition("*")
    kw = {}
    if weights:
        q = quantize_weight(w, bits=int(weights[3:]))
        b, kw = q.values, dict(scale=q.scales, b_bits=q.bits)
    else:
        b = w.to(torch.bfloat16 if act == "bf16" else torch.float32)
    if act == "int8":
        a, kw["scale_a"] = quantize_activations(a)
        return a, b, kw, torch.float32
    a = a.to(torch.bfloat16) if act == "bf16" else a
    return a, b, kw, a.dtype


def test_cuda_streamk_region_leaves_counters_at_zero(cuda_device):
    """50 fused Stream-K regions back to back, no host synchronisation
    between them, of mixed shapes (ragged M, N and K, odd K, the router's
    4x64x2048), policies (ALL_SK and HYBRIDs), grid sizes and all eight
    operand pairs: each writes what the plain composition writes (2e-2 x
    max|ref| for bf16 output, 1e-4 for f32), and a copy of the arrival
    counters queued behind each launch reads all 0, so every launch leaves
    them as it found them. Many of the cases split a tile."""
    shapes = ((4, 1024, 4096), (20, 300, 520), (57, 302, 203), (64, 384, 1152), (4, 64, 2048))
    pols = (ALL_SK, *HYBRIDS[:3])
    cases, i = [], 0
    while len(cases) < 50:
        pair, (m, n, k) = REGION_PAIRS[i % 8], shapes[i % 5]
        pol, g = pols[i % 4], (7, 66, 132)[i % 3]
        i += 1
        cfg = TileConfig(8 if m <= 8 else 16, 128 * (1 + i % 2), 128)
        part = partition(GemmShape(m, n, k), cfg, g, pol)
        if not part.sk_tiles:
            continue
        a, b, kw, out = _pair_operands(pair, m, n, k, seed=i)
        bits = kw.pop("b_bits", 8)
        want = streamk_region(a, b, part, torch.zeros(m, n, dtype=out), b_bits=bits, **kw)
        cases.append((pair, part, a.to(cuda_device), b.to(cuda_device), _to(kw, cuda_device),
                      bits, out, want))
    device = cases[0][2].device  # the kernels' own key: cuda:<index>
    counters = common.arrival_counters(max(c[1].sk_tiles for c in cases), device)
    outs, snaps = [], []
    for pair, part, a, b, kw, bits, out, _ in cases:
        c = torch.zeros(a.shape[0], b.shape[1], dtype=out, device=cuda_device)
        outs.append(streamk_region(a, b, part, c, b_bits=bits, **kw))
        snaps.append(counters.clone())
    assert common.arrival_counters(1, device) is counters
    assert common.arrival_counters(1, cuda_device) is counters
    split = 0
    for (pair, part, *_, out, want), got, snap in zip(cases, outs, snaps):
        what = (pair, part.shape, part.cfg.name, part.g, part.policy.name)
        _close_max(got, want, TOL[out], what)
        assert not snap.any(), what
        split += part.max_contributors > 1
    assert split >= 10, split


@pytest.mark.parametrize("pair", list(FMA_BITS))
@pytest.mark.parametrize("bm", [8, 16, 32, 64], ids=lambda bm: f"sm{bm}")
def test_cuda_fma_grouped_sk_matches_plain_version(cuda_device, bm, pair):
    """B5's Stream-K form (B5a) on the f32 FMA mainloop at sub-block rows
    SM = bm (TN = 4 columns a lane at SM 8-32, 2 at SM = 64), against
    gemm_grouped_streamk_plain at 1e-4 x max|ref| (f32 sums over K slices in
    another order): MMA_SHAPES (ragged N and K, odd K, rows that are not
    16-byte aligned) with full and ragged group sizes (an empty group), bn
    128 and 256, bk 128 and 256, g 7, 132 and one whose segments start at
    odd multiples of bk, no epilogue and every stage (the per-expert scale
    for int8 and int4). Whole tiles flush from registers and split tiles
    park and meet in the shared tail; both occur. Every call runs twice with
    the same bytes, short groups leave their rows 0, and each call counts
    one launch of B5a on its rung."""
    bits = FMA_BITS[pair]
    b_bits = bits or 8
    assert common.sub_block_rows(bm, 64) == bm
    assert common.mainloop("grouped_streamk_sk", torch.float32) == "fma"
    split = whole = 0
    for gm, m, n, k in MMA_SHAPES:
        a, b, qkw, _ = _fma_operands((gm,), m, n, k, bits, seed=bm + n + k + 1)
        r = np.random.default_rng(bm + k + 1)
        bias = torch.from_numpy(r.normal(size=(gm, n)).astype(np.float32))
        operand = torch.from_numpy(r.normal(size=(gm, m, n)).astype(np.float32))
        da, db, dq = a.to(cuda_device), b.to(cuda_device), _to(qkw, cuda_device)
        rung = common.launch_name("grouped_streamk_sk", common.rung_of(a.dtype, b.dtype, b_bits))
        for sizes in ((m,) * gm, (0, m, 7, 33, 1)[:gm]):
            for epi, reads in S8_EPILOGUES:
                ekw = {key: v for key, v in (("bias", bias), ("operand", operand))
                       if key in reads}
                want = gemm_grouped_streamk_plain(a, b, sizes=sizes, out_dtype=torch.float32,
                                                  epilogue=epi, **qkw, **ekw)
                dev_e = _to(ekw, cuda_device)
                for bn in (128, 256):
                    for bk in (128, 256):
                        n_tiles = sum(-(-s_ // bm) for s_ in sizes) * -(-n // bn)
                        ipt = -(-k // bk)
                        for g in (7, 132, -(-n_tiles * ipt // 3)):
                            what = ("B5a", pair, bm, gm, m, n, k, bn, bk, sizes, epi.name, g)
                            with common.count_launches() as log:
                                run = [gemm_grouped_streamk(
                                    da, db, policy=ALL_SK, cfg=TileConfig(bm, bn, bk), g=g,
                                    out_dtype=torch.float32, epilogue=epi, group_sizes=sizes,
                                    **dq, **dev_e) for _ in range(2)]
                            assert log == [rung, rung], what
                            assert torch.equal(run[0], run[1]), what
                            _close_max(run[0], want, 1e-4, what)
                            for i, s_ in enumerate(sizes):
                                assert not run[0][i, s_:].any(), what
                            ipw = -(-n_tiles * ipt // g)
                            splits = n_tiles * ipt > ipw and ipw % ipt != 0
                            split += splits
                            whole += ipw >= ipt
    assert split and whole, (split, whole)


@pytest.mark.parametrize("profile", ["bfloat16", "int8*int8", "float32"])
def test_cuda_measure_wallclock_times_the_kernels(cuda_device, profile):
    """``measure_wallclock``, the tuner's clock on the card, over every Hopper
    tile the sweep keeps for the profile (``vmem_working_set`` within the
    H100's 232,448 bytes) x every policy x g in {66, 132, 264}, and, for bf16,
    a fused grouped target over the same space. Each measurement launches
    only the port's kernels, as many times as its policy's partition implies,
    gives a finite positive TFLOP/s, and its last output holds ``gemm_ref``
    at the kernel tolerance (the output's dtype). A pair the kernels do not
    take raises."""
    from repro_torch.core import costmodel
    from repro_torch.core.op import GemmOp
    from repro_torch.core.policies import HOPPER_TILE_CONFIGS
    from repro_torch.core.tuner import measure_wallclock
    from repro_torch.kernels.streamk.ref import gemm_ref

    measure = measure_wallclock(warmup=1, iters=2)
    calls = 3
    dt = costmodel.profile_for(profile)
    tiles = [c for c in HOPPER_TILE_CONFIGS
             if costmodel.vmem_working_set(c, dt) <= costmodel.H100.vmem_bytes]
    assert tiles and (profile == "float32") == (len(tiles) < len(HOPPER_TILE_CONFIGS))
    rung = common.rung_of(torch.int8, torch.int8) if profile == "int8*int8" else None
    targets = [GemmOp.plain(40, 392, 520, in_dtype=profile)]
    if profile == "bfloat16":
        targets.append(GemmOp(16, 384, 520, g=6, kind="grouped", fused=True,
                              in_dtype=profile, out_dtype=profile))
    n = 0
    for op in targets:
        shape = costmodel.op_shape(op)
        for cfg in tiles:
            for pol in ALL_POLICIES:
                for g in costmodel.default_grid_sizes(costmodel.H100):
                    what = (op.key, cfg.name, pol.name, g)
                    with common.count_launches() as log:
                        tflops = measure(shape, pol, cfg, g, dt)
                    if op.fused:
                        name = "grouped_streamk_dp" if pol is DP else "grouped_streamk_sk"
                        want = [common.launch_name(name, rung)] * calls
                    else:
                        part = partition(GemmShape(op.m, op.n, op.k), cfg, g, pol)
                        per = [common.launch_name("streamk_phase1", rung)] * bool(part.sk_tiles)
                        if part.dp_tiles or not part.sk_tiles:
                            per.append(common.launch_name("dp_gemm_region", rung))
                        want = per * calls
                    assert sorted(log) == sorted(want), what
                    assert np.isfinite(tflops) and tflops > 0, what
                    a, b, c = measure.last
                    ref = (torch.bmm(a.float(), b.float()) if op.fused else gemm_ref(
                        a, b, torch.float32))
                    _close_max(c, ref, TOL[c.dtype], what)
                    n += 1
    assert n == len(targets) * len(tiles) * len(ALL_POLICIES) * 3
    if profile == "float32":
        with pytest.raises(NotImplementedError, match="no CUDA kernel"):
            measure(GemmShape(8, 128, 128), DP, tiles[0], 66,
                    costmodel.profile_for("bfloat16*float32"))


# ---------------------------------------------------------------------------
# Paged serving: the paged engine's decode step, chunked prefill, the pool
# ---------------------------------------------------------------------------


def _reduced_f32(device, **over):
    model = LM(dataclasses.replace(get_reduced("granite-8b"), dtype="float32", **over))
    return model, model.init_params(device, torch.Generator(device=device).manual_seed(0))


def test_cuda_paged_decode_step_matches_dense_step(cuda_device):
    """One paged decode step (gather, decode_step on the view, scatter) on
    the ``cuda`` backend against the dense engine's step on the same
    prefilled requests (the paged side chunked): the same logits within 1e-4
    x max|logit|, and the K row the step wrote, read back from the pool,
    within 1e-4 of the dense cache's."""
    from repro_torch.serve import PagedServeConfig, PagedServeEngine, PageTable

    model, params = _reduced_f32(cuda_device)
    prompts = [np.array(p, np.int32) for p in ([5, 17, 3, 99, 42, 7, 8, 9, 10], [200, 1, 64])]
    dense = ServeEngine(model, params, ServeConfig(n_slots=4, max_seq=32, eos=-1),
                        backend="cuda", device=cuda_device)
    paged = PagedServeEngine(model, params, PagedServeConfig(
        page_size=4, max_pages=16, max_active=4, max_seq=32, eos=-1, prefill_chunk=4),
        backend="cuda", device=cuda_device)
    for e in (dense, paged):
        for p in prompts:
            e.submit(p, max_new_tokens=4)
    dense._admit()
    paged._admit()
    while paged._prefill_tick():
        pass
    reqs = paged._decode_candidates()
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in dense.slot_req[:2]]
    tokens = np.zeros((4, 1), np.int64)
    pos = np.zeros((4,), np.int64)
    for i, r in enumerate(reqs):
        tokens[i, 0], pos[i] = r.out_tokens[-1], r.pos
    tables = [r.table for r in reqs] + [PageTable(), PageTable()]
    with paged._dispatch_ctx():
        got = paged._paged_decode(paged.kv.padded_tables(tables), tokens, pos, len(reqs))
    with gemm_context(selector=dense.selector, backend="cuda", device=cuda_device):
        want, _ = model.decode_step(params, dense.cache,
                                    torch.as_tensor(tokens, device=cuda_device),
                                    torch.as_tensor(dense.pos, device=cuda_device))
    got, want = got[:2].float().cpu(), want[:2].float().cpu()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    for i, r in enumerate(reqs):
        page, off = r.table.pages[r.pos // 4], r.pos % 4
        row = paged.kv.pool["attn"]["k"][:, page, off].float().cpu()
        ref = dense.cache["attn"]["k"][:, i, r.pos].float().cpu()
        assert (row - ref).abs().max() <= 1e-4 * max(1.0, ref.abs().max())


def test_cuda_prefill_chunk_matches_torch_backend(cuda_device):
    """``prefill_chunk`` on the ``cuda`` backend against the ``torch``
    backend on the card: logits within 1e-4 x max|logit|, the chunk's cache
    rows within 1e-4 x max|row|."""
    model, params = _reduced_f32(cuda_device)
    prompt = torch.tensor([[5, 17, 3, 99, 42, 7, 11, 2, 8, 61, 30, 12, 4]], device=cuda_device)
    out = {}
    for backend in ("cuda", "torch"):
        with gemm_context(backend=backend, device=cuda_device):
            _, cache = model.prefill(params, prompt[:, :5], max_seq=16)
            logits, cache = model.prefill_chunk(params, cache, prompt[:, 5:],
                                                torch.tensor([5], device=cuda_device))
        out[backend] = logits.float().cpu(), {k: v.float().cpu() for k, v in cache["attn"].items()}
    (got, gc), (want, wc) = out["cuda"], out["torch"]
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    for key in gc:
        assert (gc[key][:, :, :13] - wc[key][:, :, :13]).abs().max() <= 1e-4 * max(
            1.0, wc[key].abs().max())


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_cuda_pool_adapters_match_cpu(cuda_device, kv):
    """The pool adapters on CUDA tensors give the CPU's values bit for bit
    (the scratch page, which padded rows write in any order, aside)."""
    from repro_torch.serve import PagedKVCache, PageTable

    model = LM(dataclasses.replace(get_reduced("granite-8b"), kv_cache_dtype=kv))
    ps = 4
    pools = {dev: PagedKVCache(model, page_size=ps, n_pages=7, device=dev)
             for dev in ("cpu", cuda_device)}
    gen = torch.Generator().manual_seed(0)
    for key, a in pools["cpu"].pool["attn"].items():
        a.copy_(torch.randint(-127, 128, a.shape, generator=gen).to(a.dtype)
                if a.dtype == torch.int8 else torch.randn(a.shape, generator=gen).to(a.dtype))
        pools[cuda_device].pool["attn"][key].copy_(a)
    tables = [PageTable([3, 0, 5]), PageTable([6]), PageTable(), PageTable()]
    pages_2d = pools["cpu"].padded_tables(tables)
    pos = np.array([9, 2, 0, 0])
    res = {}
    for dev, kvc in pools.items():
        view = kvc.gather_view(kvc.pool, pages_2d)
        rows = kvc.rows_at(view, pos)
        rows = {"attn": {k: r.flip(1).contiguous() for k, r in rows["attn"].items()}}
        kvc.scatter_rows(kvc.pool, pages_2d[np.arange(4), pos // ps], pos % ps, rows)
        fresh = kvc.gather_view(kvc.pool, np.array([[6, 3]]))
        kvc.scatter_prefill(kvc.pool, [1, 4], fresh)
        res[dev] = view, {k: a[:, :7] for k, a in kvc.pool["attn"].items()}
    for key in res["cpu"][0]["attn"]:
        assert torch.equal(res["cpu"][0]["attn"][key], res[cuda_device][0]["attn"][key].cpu())
        assert torch.equal(res["cpu"][1][key], res[cuda_device][1][key].cpu())


GRAD_EPILOGUES = [Epilogue(), Epilogue(bias=True), Epilogue(activation="gelu"),
                  Epilogue(activation="square"), Epilogue(binary="mul_silu"),
                  Epilogue(activation="gelu", bias=True, binary="add")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["plain", "grouped", "grouped_loop"])
@pytest.mark.parametrize("epi", GRAD_EPILOGUES, ids=lambda e: e.name)
def test_cuda_gemm_grad_matches_autograd_through_the_torch_backend(cuda_device, epi, kind,
                                                                   dtype):
    """A dispatch with grad on the card: the forward launches the kernels
    (the same bits as without grad) and ``GemmGrad``'s gradients equal
    autograd's through the ``torch`` backend (dX, dW, dbias, doperand)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    g, m, k, n = (1, 96, 512, 384) if kind == "plain" else (8, 40, 512, 384)
    lead = () if kind == "plain" else (g,)
    r = lambda *shape: torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    ops_in = {"x": r(*lead, m, k), "w": r(*lead, k, n) / k ** 0.5}
    if epi.bias:
        ops_in["bias"] = r(*lead, n)
    if epi.binary != "none":
        ops_in["operand"] = r(*lead, m, n)

    def run(backend, grad=True):
        leaves = {key: v.clone().requires_grad_(grad) for key, v in ops_in.items()}
        kw = dict(epilogue=epi, bias=leaves.get("bias"), operand=leaves.get("operand"))
        with gemm_context(backend=backend):
            if kind == "plain":
                out = gemm(leaves["x"], leaves["w"], **kw)
            else:
                out = gemm_grouped(leaves["x"], leaves["w"], fused=kind == "grouped", **kw)
        if not grad:
            return out, None
        out.backward(torch.linspace(-1, 1, out.numel(), device="cuda").reshape(out.shape)
                     .to(out.dtype))
        return out.detach(), {key: v.grad for key, v in leaves.items()}

    common.reset_launch_counts()
    out, got = run("cuda")
    assert sum(common.LAUNCHES.values()) > 0
    assert torch.equal(out, run("cuda", grad=False)[0])
    _, want = run("torch")
    tol = TOL[dtype]
    for key, ref in want.items():
        assert got[key] is not None and got[key].dtype == ref.dtype, key
        scale = max(1.0, ref.float().abs().max().item())
        assert (got[key].float() - ref.float()).abs().max().item() <= tol * scale, key


# ---------------------------------------------------------------------------
# The compiled decode step: graph replay against eager
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
def test_cuda_engines_replay_the_eager_decode(cuda_device, paged):
    """The slot and paged engines on the card decode by CUDA graph replay
    (``step_mode`` "graph", one capture per key) and give the greedy tokens
    and the kernels' launch counts of the same engines under
    ``disable_graphs()``: the captured launches count once a replay."""
    from repro_torch.serve import PagedServeConfig, PagedServeEngine, disable_graphs

    model, params = _reduced_f32(cuda_device)
    prompts = [np.array(p, np.int32) for p in ([5, 17, 3, 99, 42, 7, 8, 9, 10], [200, 1],
                                               [9] * 14)]

    def serve():
        if paged:
            eng = PagedServeEngine(model, params, PagedServeConfig(
                page_size=4, max_pages=24, max_active=3, max_seq=40, eos=-1), backend="cuda",
                device=cuda_device)
        else:
            eng = ServeEngine(model, params, ServeConfig(n_slots=3, max_seq=40, eos=-1),
                              backend="cuda", device=cuda_device)
        mode = eng.step_mode
        for p in prompts:
            eng.submit(p, max_new_tokens=10)
        common.reset_launch_counts()
        done = {r.uid: r.out_tokens for r in eng.run()}
        torch.cuda.synchronize()
        return eng, mode, done, dict(common.LAUNCHES)

    eng, mode, tokens, launches = serve()
    with disable_graphs():
        eager, eager_mode, want, eager_launches = serve()
    assert (mode, eager_mode) == ("graph", "eager")
    step = eng.decode
    assert step.captured and step.replays > 0 and not eager.decode.captured
    assert len({c.key for c in step.captured}) == len(step.captured)
    assert tokens == want
    assert launches == eager_launches
