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

from repro_torch.configs import get_reduced
from repro_torch.core.gemm import gemm, gemm_batched, gemm_context, gemm_grouped
from repro_torch.core.op import Epilogue
from repro_torch.core.policies import ALL_POLICIES, ALL_SK, DP, HYBRIDS, TileConfig
from repro_torch.core.quant import quantize_activations, quantize_weight
from repro_torch.core.workpart import GemmShape, partition
from repro_torch.kernels import common
from repro_torch.kernels.dp import ops as dp_ops
from repro_torch.kernels.dp.dp_gemm import dp_gemm_region
from repro_torch.kernels.splitk import ops as splitk_ops
from repro_torch.kernels.splitk.splitk_gemm import splitk_partials, splitk_partials_plain
from repro_torch.kernels.streamk import ops
from repro_torch.kernels.streamk.grouped import gemm_grouped_streamk, gemm_grouped_streamk_plain
from repro_torch.kernels.streamk.streamk_gemm import streamk_fixup, streamk_phase1
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


def test_cuda_streamk_is_bitwise_deterministic(cuda_device):
    """B2 then B3 sum the contributor slots in a fixed order: two runs give
    the same bits."""
    a, b, _, _ = (t.to(cuda_device) for t in _inputs(4, 4096, 4096, torch.bfloat16, seed=5))
    part = partition(GemmShape(4, 4096, 4096), TileConfig(8, 256, 128), 132, ALL_SK)
    assert part.max_contributors > 1
    outs = []
    for _ in range(2):
        c = torch.empty(4, 4096, dtype=a.dtype, device=cuda_device)
        outs.append(streamk_fixup(streamk_phase1(a, b, part), part, c))
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


def test_cuda_grouped_streamk_is_bitwise_deterministic(cuda_device):
    """The olmoe prefill shape under ALL_SK splits tiles between blocks; the
    last contributor sums the slots in a fixed order: two runs, same bits."""
    a, b, _, _ = (t.to(cuda_device) for t in _grouped_inputs(64, 16, 1024, 2048,
                                                               torch.bfloat16, seed=9))
    cfg = TileConfig(16, 128, 128)
    ipt, total = 2048 // 128, 64 * 8 * (2048 // 128)
    assert (-(-total // 132)) % ipt  # a workgroup boundary falls inside a tile
    outs = [gemm_grouped_streamk(a, b, policy=ALL_SK, cfg=cfg, g=132) for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    _close(outs[0], gemm_grouped_streamk_plain(a, b, sizes=(16,) * 64, out_dtype=a.dtype),
           TOL[torch.bfloat16])


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
