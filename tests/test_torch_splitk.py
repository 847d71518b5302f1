"""Parity of the port's baseline GEMM families and ``gemm_batched`` with the
JAX package.

The same numpy-seeded inputs go through ``repro``'s split-K and DP
baselines (``repro.kernels.splitk.ops.gemm``, ``repro.kernels.dp.ops.gemm``,
Pallas in interpret mode, as the JAX package's own tests run them on the
CPU) and the port's (``repro_torch.kernels.splitk.ops.gemm``,
``repro_torch.kernels.dp.ops.gemm`` on CPU tensors, where B6's and B1's
wrappers run their plain PyTorch versions). It mirrors
``tests/test_kernels.py::test_splitk_gemm``, the wave-grid tests of
``tests/test_policy_degenerate.py`` and the split-K/DP tests of
``tests/test_quant_differential.py``, on the dense pairs and all six
quantized operand pairs. B6's partials are held against ``repro``'s
(padded, so cut to ``[:, :M, :N]``), empty splits included; and
``gemm_batched`` against ``repro``'s, keyed in the 7-part loop form.

Tolerances (docs/kernels.md): 1e-4 for f32 activations and the int8/int4
operands (int8 -> f32 widening is exact, the int8-activation MAC sums exact
int32 k-steps; what is left is f32 summation order); 2e-2 for bf16 (the
bf16 rounding of inputs near 1). The CUDA kernel runs only on the card:
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold it against the plain
version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.core.gemm import gemm_batched as j_gemm_batched
from repro.core.gemm import gemm_context as j_gemm_context
from repro.core.policies import TileConfig as JTile
from repro.core.selector import default_selector as j_default_selector
from repro.kernels.common import pad_to as jpad_to
from repro.kernels.dp import ops as j_dp_ops
from repro.kernels.splitk import ops as j_splitk_ops
from repro.kernels.splitk import splitk_partials as j_splitk_partials
from repro_torch.core import quant as tq
from repro_torch.core.gemm import gemm_batched, gemm_context
from repro_torch.core.policies import TileConfig
from repro_torch.core.selector import default_selector
from repro_torch.kernels import common
from repro_torch.kernels.dp import ops as dp_ops
from repro_torch.kernels.splitk import ops as splitk_ops
from repro_torch.kernels.splitk import ref as splitk_ref
from repro_torch.kernels.splitk import splitk_partials
from repro_torch.kernels.splitk.splitk_gemm import splitk_partials_plain

CFG = (8, 128, 128)
ODD = (17, 200, 300)  # ragged on every dim: 3 x 2 tiles, K ragged against bk

#: operand pair -> (activation dtype, weight bits or None for a dense weight,
#: int8 activations, tolerance)
PAIRS = {
    "float32": ("float32", None, False, 1e-4),
    "bfloat16": ("bfloat16", None, False, 2e-2),
    "float32*int8": ("float32", 8, False, 1e-4),
    "bfloat16*int8": ("bfloat16", 8, False, 2e-2),
    "int8*int8": ("float32", 8, True, 1e-4),
    "float32*int4": ("float32", 4, False, 1e-4),
    "bfloat16*int4": ("bfloat16", 4, False, 2e-2),
    "int8*int4": ("float32", 4, True, 1e-4),
}
QUANT_PAIRS = [p for p in PAIRS if "*" in p]


def _operands(m, n, k, pair, *, lead=(), seed=0):
    """(jax args, jax kwargs), (torch args, torch kwargs) of one operand
    pair, made by each package from the same numpy values: a dense weight
    rounded to the activation dtype, or a weight quantized per output
    channel (int8 activations quantized per row) with its scales and
    b_bits."""
    act, bits, act_q, _ = PAIRS[pair]
    r = np.random.default_rng(seed)
    a = r.normal(size=(*lead, m, k)).astype(np.float32)
    w = (r.normal(size=(*lead, k, n)) / np.sqrt(k)).astype(np.float32)
    ja, ta = jnp.asarray(a, act), torch.from_numpy(a).to(getattr(torch, act))
    if bits is None:
        return (ja, jnp.asarray(w, act), {}), (ta, torch.from_numpy(w).to(ta.dtype), {})
    jw = jq.quantize_weight(jnp.asarray(w), bits=bits)
    tw = tq.quantize_weight(torch.from_numpy(w), bits=bits)
    jkw, tkw = dict(scale=jw.scales, b_bits=bits), dict(scale=tw.scales, b_bits=bits)
    if act_q:
        ja, jkw["scale_a"] = jq.quantize_activations(ja)
        ta, tkw["scale_a"] = tq.quantize_activations(ta)
    return (ja, jw.values, jkw), (ta, tw.values, tkw)


def _close(got, want, tol):
    np.testing.assert_allclose(
        got.to(torch.float32).numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol
    )


# ---------------------------------------------------------------------------
# split-K (B6) and DP through their ops.gemm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 2, 4])
def test_splitk_gemm(s):
    """``test_kernels.py::test_splitk_gemm``: f32 16x256x1024 at s in
    {1, 2, 4}, against repro's split-K (interpret) and the oracle."""
    (ja, jb, _), (ta, tb, _) = _operands(16, 256, 1024, "float32", seed=1)
    want = j_splitk_ops.gemm(ja, jb, cfg=JTile(*CFG), s=s, interpret=True)
    got = splitk_ops.gemm(ta, tb, cfg=TileConfig(*CFG), s=s)
    assert got.dtype == torch.float32 and tuple(got.shape) == (16, 256)
    _close(got, want, 1e-4)
    _close(got, splitk_ref.gemm_ref(ta, tb), 1e-4)


@pytest.mark.parametrize("g", [0, 3, 8, 16])
def test_splitk_ops_wave_grid_matches_repro(g):
    """The wave-grid size only schedules the tiles: every ``g`` gives
    repro's product (``test_policy_degenerate.py``)."""
    (ja, jb, _), (ta, tb, _) = _operands(24, 256, 512, "float32", seed=5)
    want = j_splitk_ops.gemm(ja, jb, cfg=JTile(*CFG), s=2, g=g, interpret=True)
    _close(splitk_ops.gemm(ta, tb, cfg=TileConfig(*CFG), s=2, g=g), want, 1e-4)


@pytest.mark.parametrize("g", [0, 3, 8, 16])
def test_dp_ops_wave_grid_matches_repro(g):
    (ja, jb, _), (ta, tb, _) = _operands(*ODD, "float32", seed=4)
    want = j_dp_ops.gemm(ja, jb, cfg=JTile(*CFG), g=g, interpret=True)
    got = dp_ops.gemm(ta, tb, cfg=TileConfig(*CFG), g=g)
    assert got.dtype == torch.float32 and tuple(got.shape) == ODD[:2]
    _close(got, want, 1e-4)


@pytest.mark.parametrize("pair", list(PAIRS))
@pytest.mark.parametrize("g", [0, 3])
def test_splitk_ops_every_pair_matches_repro(g, pair):
    """``test_quant_differential.py``'s split-K tests on every operand pair:
    s = 2 at 24x256x512, the dequant scales after the reduction."""
    (ja, jb, jkw), (ta, tb, tkw) = _operands(24, 256, 512, pair, seed=14)
    want = j_splitk_ops.gemm(ja, jb, cfg=JTile(*CFG), s=2, g=g, interpret=True,
                             out_dtype=jnp.float32, **jkw)
    got = splitk_ops.gemm(ta, tb, cfg=TileConfig(*CFG), s=2, g=g, out_dtype=torch.float32,
                          **tkw)
    _close(got, want, PAIRS[pair][3])


@pytest.mark.parametrize("pair", list(PAIRS))
@pytest.mark.parametrize("g", [0, 3])
def test_dp_ops_every_pair_matches_repro(g, pair):
    """``test_quant_differential.py``'s DP tests on every operand pair, at
    the shape ragged on every dim."""
    (ja, jb, jkw), (ta, tb, tkw) = _operands(*ODD, pair, seed=13)
    want = j_dp_ops.gemm(ja, jb, cfg=JTile(*CFG), g=g, interpret=True,
                         out_dtype=jnp.float32, **jkw)
    got = dp_ops.gemm(ta, tb, cfg=TileConfig(*CFG), g=g, out_dtype=torch.float32, **tkw)
    _close(got, want, PAIRS[pair][3])


@pytest.mark.parametrize("pair", QUANT_PAIRS)
def test_splitk_ops_quantized_odd_k_matches_dequantized_reference(pair):
    """An odd K (int4's zero pad nibble) over 3 splits, one of them ragged:
    the port's split-K against dequantize-then-matmul."""
    m, n, k = 9, 200, 333
    _, (ta, tb, tkw) = _operands(m, n, k, pair, seed=21)
    a_ref = ta.to(torch.float32)
    if "scale_a" in tkw:
        a_ref = a_ref * tkw["scale_a"][:, None]
    w_ref = common.unpack_b(tb, tkw["b_bits"], k).to(torch.float32) * tkw["scale"][None, :]
    got = splitk_ops.gemm(ta, tb, cfg=TileConfig(*CFG), s=3, out_dtype=torch.float32, **tkw)
    _close(got, (a_ref @ w_ref).numpy(), PAIRS[pair][3])


# ---------------------------------------------------------------------------
# B6's partials
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pair", ["float32", "int8*int8", "int8*int4", "bfloat16*int4"])
@pytest.mark.parametrize("k,s", [(520, 2), (520, 4), (200, 4)], ids=["s2", "s4", "empty"])
def test_splitk_partials_match_repro(k, s, pair):
    """Each split's partial equals repro's (its padded ``(s, Mp, Np)``
    partials cut to ``[:, :M, :N]``); at K = 200 < bk * s the last two
    splits are empty and read 0, as repro's zero-padded splits do."""
    m, n = 20, 300
    (ja, jb, jkw), (ta, tb, tkw) = _operands(m, n, k, pair, seed=3)
    bits = tkw.get("b_bits", 8)
    cfg = JTile(*CFG)
    ap = jpad_to(ja, (cfg.bm, cfg.bk * s))
    bp = jpad_to(jb, (cfg.bk * s // 2 if bits == 4 else cfg.bk * s, cfg.bn))
    want = np.asarray(j_splitk_partials(ap, bp, cfg, s, interpret=True, b_bits=bits))
    got = splitk_partials(ta, tb, TileConfig(*CFG), s, b_bits=bits)
    assert got.dtype == torch.float32 and tuple(got.shape) == (s, m, n)
    _close(got, want[:, :m, :n], PAIRS[pair][3])
    if k < cfg.bk * s:
        empty = -(-k // cfg.bk)  # the first split past K
        assert empty < s and not got[empty:].any()
    assert torch.equal(got, splitk_partials_plain(ta, tb, TileConfig(*CFG), s, b_bits=bits))


def test_splitk_int8_activations_sum_each_k_step_in_order():
    """With int8 activations each split adds its bk steps' exact int32
    products into its f32 partial in order, as the kernel does; the splits
    then sum in f32 and the scales apply once."""
    (_, _, _), (ta, tb, tkw) = _operands(9, 200, 700, "int8*int4", seed=17)
    b = common.unpack_b(tb, 4, 700).to(torch.int64)
    a = ta.to(torch.int64)
    s, span = 2, 3 * CFG[2]  # ceil(ceil(700 / 128) / 2) = 3 k-steps a split
    parts = []
    for sp in range(s):
        acc = torch.zeros(9, 200)
        for k0 in range(sp * span, min((sp + 1) * span, 700), CFG[2]):
            k1 = min(k0 + CFG[2], (sp + 1) * span, 700)
            acc = acc + (a[:, k0:k1] @ b[k0:k1]).to(torch.float32)
        parts.append(acc)
    want = torch.stack(parts).sum(0) * tkw["scale_a"][:, None] * tkw["scale"][None, :]
    got = splitk_ops.gemm(ta, tb, cfg=TileConfig(*CFG), s=s, out_dtype=torch.float32, **tkw)
    assert torch.equal(got, want)


def test_splitk_partials_count_no_launch_on_the_cpu():
    """CPU tensors run the plain version: nothing launches, nothing counts."""
    common.reset_launch_counts()
    (_, _, _), (ta, tb, _) = _operands(8, 128, 256, "float32")
    with common.count_launches() as log:
        splitk_ops.gemm(ta, tb, cfg=TileConfig(*CFG), s=2)
        dp_ops.gemm(ta, tb, cfg=TileConfig(*CFG))
    assert log == [] and sum(common.LAUNCHES.values()) == 0
    assert common.LAUNCHES["splitk_partials"] == 0
    assert "splitk_partials[int4-dynamic]" in common.LAUNCHES


# ---------------------------------------------------------------------------
# bad operands
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["splitk", "dp"])
def test_bad_operands_raise(family):
    """``test_kernels.py::test_bad_operands_raise`` for both baselines, plus
    a packed int4 B of the wrong row count and an unknown ``b_bits``."""
    gemm_fn = splitk_ops.gemm if family == "splitk" else dp_ops.gemm
    with pytest.raises(ValueError):
        gemm_fn(torch.zeros(4, 8), torch.zeros(9, 4))
    with pytest.raises(ValueError):
        gemm_fn(torch.zeros(4, 8), torch.zeros(8, 4)[None])
    with pytest.raises(ValueError):  # 9 // 2 + 1 = 5 packed rows, not 4
        gemm_fn(torch.zeros(4, 9, dtype=torch.int8), torch.zeros(4, 4, dtype=torch.int8),
                b_bits=4)
    with pytest.raises(ValueError, match="b_bits"):
        gemm_fn(torch.zeros(4, 8), torch.zeros(8, 4), b_bits=2)
    if family == "splitk":
        with pytest.raises(ValueError, match="split factor"):
            gemm_fn(torch.zeros(4, 8), torch.zeros(8, 4), s=0)


# ---------------------------------------------------------------------------
# gemm_batched
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_batched_matches_repro_in_the_loop_form(backend):
    """``test_gemm_op.py::test_batched_matches_einsum`` and
    ``test_grouped_streamk.py::test_batched_dispatch_stays_loop``: the same
    product as repro's ``gemm_batched``, and the same 7-part, unfused op
    key, through the torch backend and the cuda backend's plain path (the
    policy composition once per batch entry)."""
    r = np.random.default_rng(1)
    x = r.normal(size=(3, 5, 160)).astype(np.float32)
    w = r.normal(size=(3, 160, 136)).astype(np.float32)
    with j_gemm_context(selector=j_default_selector()) as jctx:
        want = j_gemm_batched(jnp.asarray(x), jnp.asarray(w))
    with gemm_context(selector=default_selector(), backend=backend, device="cpu") as ctx:
        got = gemm_batched(torch.from_numpy(x), torch.from_numpy(w))
    _close(got, want, 1e-4)
    np.testing.assert_allclose(got.numpy(), np.einsum("gmk,gkn->gmn", x, w), rtol=1e-4,
                               atol=1e-4)
    [e], [je] = ctx.log, jctx.log
    assert e.op.kind == "batched" and not e.op.fused and len(e.op.key) == 7
    assert e.op.key == je.op.key and e.op.g == 3


def test_batched_quantized_weight_matches_repro():
    """A stacked int4 weight quantized for int8 activations: the int8 x int4
    pair through ``gemm_batched``, against repro's."""
    r = np.random.default_rng(2)
    x = r.normal(size=(2, 7, 200)).astype(np.float32)
    w = r.normal(size=(2, 200, 128)).astype(np.float32)
    jw = jq.quantize_weight(jnp.asarray(w), bits=4, act_bits=8)
    tw = tq.quantize_weight(torch.from_numpy(w), bits=4, act_bits=8)
    with j_gemm_context(selector=j_default_selector()) as jctx:
        want = j_gemm_batched(jnp.asarray(x), jw)
    with gemm_context(selector=default_selector(), backend="cuda", device="cpu") as ctx:
        got = gemm_batched(torch.from_numpy(x), tw)
    _close(got, want, 1e-4)
    assert ctx.log[0].op.in_dtype == jctx.log[0].op.in_dtype == "int8*int4"
    assert ctx.log[0].op.key == jctx.log[0].op.key


def test_batched_shape_validation():
    with pytest.raises(ValueError):
        gemm_batched(torch.ones(2, 4, 8), torch.ones(3, 8, 4))  # B mismatch
    with pytest.raises(ValueError):
        gemm_batched(torch.ones(2, 4, 8), torch.ones(2, 9, 4))  # K mismatch
    with pytest.raises(ValueError):
        gemm_batched(torch.ones(4, 8), torch.ones(8, 4))  # not stacked
