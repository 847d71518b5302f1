"""Parity of the port's Stream-K++ kernel modules with the JAX package.

The same numpy-seeded inputs go through ``repro.kernels.streamk.ops.gemm``
(Pallas in interpret mode, as the JAX package's own tests run it on the CPU)
and ``repro_torch.kernels.streamk.ops.gemm`` on CPU tensors, where every
kernel wrapper runs its plain PyTorch version through the same policy
composition. Tolerances (docs/kernels.md): 1e-4 for f32 — both sides
accumulate in f32 but in a different order; 2e-2 for bf16 — the bf16
output rounding of values near 1 dominates.

The CUDA kernels themselves cannot run here: ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` hold them against these plain versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.op import Epilogue as JEpilogue
from repro.core.policies import ALL_POLICIES as J_POLICIES
from repro.core.policies import TileConfig as JTile
from repro.core.workpart import GemmShape as JShape
from repro.core.workpart import partition as jpartition
from repro.kernels.common import pad_to as jpad_to
from repro.kernels.streamk import ops as j_ops
from repro.kernels.streamk.ref import streamk_partition_ref as j_partition_ref
from repro_torch.core.op import Epilogue
from repro_torch.core.policies import ALL_POLICIES, ALL_SK, HYBRIDS, TileConfig
from repro_torch.core.workpart import GemmShape, partition
from repro_torch.kernels import common
from repro_torch.kernels.dp.dp_gemm import dp_gemm_region, tile_index
from repro_torch.kernels.streamk import ops
from repro_torch.kernels.streamk.ref import gemm_ref, streamk_partition_ref
from repro_torch.kernels.streamk.streamk_gemm import (
    n_contributors,
    streamk_fixup,
    streamk_phase1,
    streamk_phase1_plain,
    streamk_region,
)

CFG = (8, 128, 128)
SHAPE = (20, 300, 520)  # 3 x 3 tiles, 5 k-iterations, ragged on every dim
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32, 1e-4),
          "bf16": (None, jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(m, n, k, dname, seed=0):
    """The same values for both packages: numpy f32 draws, rounded to bf16
    identically (round to nearest even) on either side."""
    r = np.random.default_rng(seed)
    a = r.normal(size=(m, k)).astype(np.float32)
    b = (r.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    bias = r.normal(size=(n,)).astype(np.float32)
    operand = r.normal(size=(m, n)).astype(np.float32)
    _, jdt, tdt, _ = DTYPES[dname]
    jx = [jnp.asarray(x, jdt) for x in (a, b, bias, operand)]
    tx = [torch.from_numpy(x).to(tdt) for x in (a, b, bias, operand)]
    return jx, tx


def _close(got, want, tol):
    np.testing.assert_allclose(
        got.to(torch.float32).numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol
    )


@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("g", [4, 16])
@pytest.mark.parametrize("pol_idx", range(len(ALL_POLICIES)),
                         ids=[p.name for p in ALL_POLICIES])
def test_policies_match_jax(pol_idx, g, dname):
    (ja, jb, _, _), (ta, tb, _, _) = _inputs(*SHAPE, dname)
    tol = DTYPES[dname][3]
    want = j_ops.gemm(ja, jb, policy=J_POLICIES[pol_idx], cfg=JTile(*CFG), g=g,
                      interpret=True, out_dtype=jnp.float32)
    got = ops.gemm(ta, tb, policy=ALL_POLICIES[pol_idx], cfg=TileConfig(*CFG), g=g,
                   out_dtype=torch.float32)
    _close(got, want, tol)


EPILOGUES = {
    "none": dict(),
    "mul_silu": dict(binary="mul_silu"),
    "bias+gelu": dict(activation="gelu", bias=True),
    "add": dict(binary="add"),
    "square": dict(activation="square"),  # nemotron-4-15b's squared-ReLU MLP
}


@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("pol_idx", [0, 1, 3], ids=["dp", "all_sk", "sk2dp"])
@pytest.mark.parametrize("epi", list(EPILOGUES))
def test_epilogues_match_jax(epi, pol_idx, dname):
    (ja, jb, jbias, jop_), (ta, tb, tbias, top_) = _inputs(*SHAPE, dname, seed=1)
    tol = DTYPES[dname][3]
    spec = EPILOGUES[epi]
    jkw = dict(epilogue=JEpilogue(**spec))
    tkw = dict(epilogue=Epilogue(**spec))
    if spec.get("bias"):
        jkw["bias"], tkw["bias"] = jbias, tbias
    if spec.get("binary"):
        jkw["operand"], tkw["operand"] = jop_, top_
    out = jnp.bfloat16 if dname == "bf16" else jnp.float32
    want = j_ops.gemm(ja, jb, policy=J_POLICIES[pol_idx], cfg=JTile(*CFG), g=4,
                      interpret=True, out_dtype=out, **jkw)
    got = ops.gemm(ta, tb, policy=ALL_POLICIES[pol_idx], cfg=TileConfig(*CFG), g=4,
                   out_dtype=DTYPES[dname][2], **tkw)
    assert got.dtype == DTYPES[dname][2]
    _close(got, want, tol)


@pytest.mark.parametrize("pol", [ALL_SK, HYBRIDS[0], HYBRIDS[2]], ids=lambda p: p.name)
@pytest.mark.parametrize("g", [4, 7])
def test_partials_match_jax_partition_ref(pol, g):
    """B2's plain version fills the same workspace slots with the same sums
    as the JAX package's Algorithm-1 oracle (f32, 1e-4: per-segment versus
    per-k-iteration summation)."""
    m, n, k = SHAPE
    (ja, jb, _, _), (ta, tb, _, _) = _inputs(m, n, k, "f32", seed=2)
    jpart = jpartition(JShape(m, n, k), JTile(*CFG), g, J_POLICIES[ALL_POLICIES.index(pol)])
    part = partition(GemmShape(m, n, k), TileConfig(*CFG), g, pol)
    want, want_c = j_partition_ref(jpad_to(ja, (8, 128)), jpad_to(jb, (128, 128)), jpart)
    got = streamk_phase1(ta, tb, part)
    assert got.shape == tuple(want.shape)
    _close(got, want, 1e-4)
    own, own_c = streamk_partition_ref(common.pad_to(ta, (8, 128)), common.pad_to(tb, (128, 128)),
                                       part)
    _close(own, want, 1e-4)
    _close(own_c, want_c, 1e-4)


@pytest.mark.parametrize("g", [4, 5])
def test_fixup_writes_only_sk_tiles(g):
    """B3 writes the Stream-K tiles into C and leaves the DP tiles alone;
    B1 from tile_offset fills the rest, and together they equal gemm_ref."""
    m, n, k = SHAPE
    _, (ta, tb, _, _) = _inputs(m, n, k, "f32", seed=3)
    part = partition(GemmShape(m, n, k), TileConfig(*CFG), g, HYBRIDS[0])
    assert 0 < part.sk_tiles < part.n_tiles_total
    c = torch.full((m, n), float("nan"))
    streamk_fixup(streamk_phase1(ta, tb, part), part, c)
    assert torch.isnan(c).sum() > 0 and not torch.isnan(c[:8, :128]).any()
    dp_gemm_region(ta, tb, TileConfig(*CFG), c=c, tile_offset=part.sk_tiles, g=g)
    _close(c, gemm_ref(ta, tb).numpy(), 1e-4)
    assert n_contributors(part).tolist() == [c_.num_contributors for c_ in part.contributions]


@pytest.mark.parametrize("kw", [dict(scale=torch.ones(300)), dict(scale_a=torch.ones(20)),
                                dict()], ids=["scale", "scale_a", "int4"])
def test_quantized_arguments_raise(kw, monkeypatch):
    """int8 activations against packed int4 weights, with or without their
    scales, once refused, now run through every phase: ALL_SK's sweep and
    fix-up and B1 give the integer product, scaled. Each packed byte 1
    holds k = 2j at 1 and k = 2j + 1 at 0, so every output is 260 times
    the scales."""
    a = torch.ones(20, 520, dtype=torch.int8)
    b = torch.ones(260, 300, dtype=torch.int8)  # ceil(520 / 2) packed rows
    calls = []
    region = ops.streamk_region
    monkeypatch.setattr(ops, "streamk_region",
                        lambda *a_, **k_: calls.append(1) or region(*a_, **k_))
    want = torch.full((20, 300), 260.0)
    for name, v in kw.items():
        want = want * (v[:, None] if name == "scale_a" else v[None, :])
    got = ops.gemm(a, b, policy=ALL_SK, cfg=TileConfig(*CFG), g=4, b_bits=4,
                   out_dtype=torch.float32, **kw)
    assert calls == [1] and torch.equal(got, want)
    got = dp_gemm_region(a, b, TileConfig(*CFG), b_bits=4, out_dtype=torch.float32, **kw)
    assert torch.equal(got, want)


def test_launch_counters_count_only_kernel_launches():
    """CPU tensors run the plain versions: no kernel launched, no count."""
    common.reset_launch_counts()
    a, b = torch.ones(20, 520), torch.ones(520, 300)
    with common.count_launches() as log:
        ops.gemm(a, b, policy=HYBRIDS[1], cfg=TileConfig(*CFG), g=4)
    assert log == [] and sum(common.LAUNCHES.values()) == 0
    common.record_launch("streamk_phase1")
    assert common.LAUNCHES["streamk_phase1"] == 1
    common.reset_launch_counts()
    assert sum(common.LAUNCHES.values()) == 0



#: the MAC each kernel runs, by activation dtype (f32, bf16, int8): a
#: tensor-core mainloop ("mma") for B1, B2, both B5 forms and B6 on bf16
#: and int8 activations, the f32 FMA mainloop ("fma") for all of them on f32
#: ones; B3 is no kernel of its own (B2 runs the fix-up in its tail)
MAINLOOPS = {
    "dp_gemm_region": ("fma", "mma", "mma"),
    "streamk_phase1": ("fma", "mma", "mma"),
    "grouped_streamk_sk": ("fma", "mma", "mma"),
    "grouped_streamk_dp": ("fma", "mma", "mma"),
    "splitk_partials": ("fma", "mma", "mma"),
}


@pytest.mark.parametrize("a_dtype", [torch.float32, torch.bfloat16, torch.int8],
                         ids=["f32", "bf16", "int8"])
@pytest.mark.parametrize("kernel", common.KERNELS)
def test_mainloop_names_each_kernels_mac(kernel, a_dtype):
    assert set(MAINLOOPS) == set(common.KERNELS)
    col = [torch.float32, torch.bfloat16, torch.int8].index(a_dtype)
    assert common.mainloop(kernel, a_dtype) == MAINLOOPS[kernel][col]
    with pytest.raises(ValueError, match="unknown kernel"):
        common.mainloop(f"{kernel}[int8]", a_dtype)


@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("g", [4, 7])
@pytest.mark.parametrize("pol", [ALL_SK, HYBRIDS[0], HYBRIDS[2]], ids=lambda p: p.name)
def test_streamk_region_matches_jax(pol, g, dname):
    """The fused Stream-K region's plain version (the sweep, then the
    fix-up) writes C's Stream-K tiles as the JAX package's composition
    writes them, with bias, a per-column dequant scale and a per-row
    scale_a in the epilogue (1e-4 for f32, 2e-2 for bf16), and leaves the
    DP tiles alone; with ``workspace=True`` it hands back the sweep's
    contributor slots."""
    m, n, k = SHAPE
    (ja, jb, jbias, _), (ta, tb, tbias, _) = _inputs(m, n, k, dname, seed=11)
    r = np.random.default_rng(12)
    scale = r.uniform(0.5, 1.5, size=n).astype(np.float32)
    scale_a = r.uniform(0.5, 1.5, size=m).astype(np.float32)
    out = jnp.bfloat16 if dname == "bf16" else jnp.float32
    want = j_ops.gemm(ja, jb, policy=J_POLICIES[ALL_POLICIES.index(pol)], cfg=JTile(*CFG),
                      g=g, interpret=True, out_dtype=out, epilogue=JEpilogue(bias=True),
                      bias=jbias, scale=jnp.asarray(scale), scale_a=jnp.asarray(scale_a))
    part = partition(GemmShape(m, n, k), TileConfig(*CFG), g, pol)
    assert part.sk_tiles
    c = torch.full((m, n), float("nan"), dtype=DTYPES[dname][2])
    got, partials = streamk_region(
        ta, tb, part, c, epilogue=Epilogue(bias=True), bias=tbias,
        scale=torch.from_numpy(scale), scale_a=torch.from_numpy(scale_a), workspace=True)
    assert got is c
    sk = tile_index(m, n, TileConfig(*CFG), "cpu") < part.sk_tiles
    assert torch.isnan(c[~sk].float()).all() and not torch.isnan(c[sk].float()).any()
    _close(c[sk], np.asarray(want.astype(jnp.float32))[sk.numpy()], DTYPES[dname][3])
    assert torch.equal(partials, streamk_phase1_plain(ta, tb, part))


@pytest.mark.parametrize("pol", [ALL_SK, HYBRIDS[0]], ids=lambda p: p.name)
def test_gemm_runs_one_streamk_region_and_no_separate_fixup(pol, monkeypatch):
    """``ops.gemm`` issues the Stream-K region (the sweep with its fix-up
    fused in) and then, for a HYBRID, the DP region: no separate fix-up
    call, and the result is gemm_ref's."""
    m, n, k = SHAPE
    _, (ta, tb, _, _) = _inputs(m, n, k, "f32", seed=13)
    calls = []
    for name in ("streamk_region", "dp_gemm_region"):
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a_, _n=name, _f=fn, **k_:
                            calls.append(_n) or _f(*a_, **k_))
    assert not hasattr(ops, "streamk_fixup") and not hasattr(ops, "streamk_phase1")
    got = ops.gemm(ta, tb, policy=pol, cfg=TileConfig(*CFG), g=4, out_dtype=torch.float32)
    part = partition(GemmShape(m, n, k), TileConfig(*CFG), 4, pol)
    assert calls == ["streamk_region"] + ["dp_gemm_region"] * bool(part.dp_tiles)
    _close(got, gemm_ref(ta, tb).numpy(), 1e-4)


@pytest.mark.parametrize("phase", ["sweep", "fixup"])
def test_phases_alone_run_only_on_cpu_tensors(phase):
    """The sweep and the fix-up on their own are plain versions: on a
    non-CPU tensor they raise, since on the card they are one kernel."""
    m, n, k = SHAPE
    part = partition(GemmShape(m, n, k), TileConfig(*CFG), 4, ALL_SK)
    a, b = torch.empty(m, k, device="meta"), torch.empty(k, n, device="meta")
    with pytest.raises(ValueError, match="streamk_region"):
        if phase == "sweep":
            streamk_phase1(a, b, part)
        else:
            streamk_fixup(torch.empty(1, device="meta"), part, torch.empty(m, n, device="meta"))
