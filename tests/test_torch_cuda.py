"""The port's Hopper kernels on the card (marker ``cuda``).

Every test here needs a CUDA device and skips without one: the kernels have
no CPU mode. The file imports neither jax nor ``repro``, so it also runs on
a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version (the one its wrapper
runs on CPU tensors) on the same inputs. Tolerances: 1e-4 for f32 (f32 sums
in another order), 2e-2 for bf16 (one bf16 rounding of the output).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.core.gemm import gemm, gemm_grouped
from repro_torch.core.op import Epilogue
from repro_torch.core.policies import ALL_POLICIES, ALL_SK, DP, HYBRIDS, TileConfig
from repro_torch.core.workpart import GemmShape, partition
from repro_torch.kernels import common
from repro_torch.kernels.dp.dp_gemm import dp_gemm_region
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
                                dict(b_bits=4)], ids=["scale", "scale_a", "int4"])
def test_cuda_wrappers_raise_on_quantized_arguments(cuda_device, kw):
    a = torch.ones(20, 520, device=cuda_device)
    b = torch.ones(520, 300, device=cuda_device)
    kw = {k: v.to(cuda_device) if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
    with common.count_launches() as log:
        with pytest.raises(NotImplementedError):
            ops.gemm(a, b, policy=ALL_SK, cfg=TileConfig(8, 128, 128), g=4, **kw)
        with pytest.raises(NotImplementedError):
            dp_gemm_region(a, b, TileConfig(8, 128, 128), **kw)
    assert log == []


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
