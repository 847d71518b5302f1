"""Parity of the port's quantization ladder with the JAX package.

* ``core.quant``: ``quantize_weight`` (int8, int4, odd K, stacked leaves),
  ``quantize_activations``, ``pack_int4``/``unpack_int4`` give byte-identical
  codes and scales to ``repro``'s on the same numpy input; ``quantize_lm_params``
  converts the same leaves.
* B1-B3's plain versions through ``ops.gemm`` (all 8 policies, two grid
  sizes) and B5's plain version against ``repro``'s kernels in Pallas
  interpret mode, on every rung: ``float32*int8``, ``int8*int8`` and
  ``float32*int4`` at 1e-4 (f32 sums in another order; the int8 x int8 MAC is
  exact per k-step), ``bfloat16*int8`` at 2e-2 (one bf16 rounding of the
  output), the tolerances of ``tests/test_quant_differential.py``.
* Dispatch: quantized ``gemm``/``gemm_grouped`` calls log the same op keys
  and selections as ``repro``'s under the same (V5E) selector.
* Reduced granite-8b and olmoe-1b-7b in f32 with ``repro``'s quantized
  parameters carried across by ``params_from_jax``: prefill logits within
  1e-4 x max|logit| and the same greedy tokens as ``repro``'s ``ServeEngine``,
  through the ``torch`` backend and the ``cuda`` backend's plain path.

The CUDA kernels themselves run only on the card: ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` hold them against these plain versions there.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.core import quant as jq
from repro.core.op import Epilogue as JEpilogue
from repro.core.policies import ALL_POLICIES as J_POLICIES
from repro.core.policies import TileConfig as JTile
from repro.core.selector import KernelSelector as JSelector
from repro.dist.sharding import materialize_tree
from repro.kernels.streamk import ops as j_ops
from repro.kernels.streamk.grouped import gemm_grouped_streamk as j_grouped
from repro.models.lm import LM as JLM
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_reduced
from repro_torch.core import quant as tq
from repro_torch.core.gemm import gemm, gemm_context, gemm_grouped
from repro_torch.core.op import Epilogue
from repro_torch.core.policies import ALL_POLICIES, DP, TileConfig
from repro_torch.core.selector import KernelSelector
from repro_torch.kernels.dp import ops as dp_ops
from repro_torch.kernels.splitk import ops as splitk_ops
from repro_torch.kernels.streamk import ops
from repro_torch.kernels.streamk.grouped import gemm_grouped_streamk, gemm_grouped_streamk_plain
from repro_torch.models.lm import LM, params_from_jax
from repro_torch.serve.engine import ServeConfig, ServeEngine

j_gemm_mod = importlib.import_module("repro.core.gemm")  # repro.core re-exports gemm()
CFG = (8, 128, 128)
ODD = (9, 200, 173)  # ragged on every dim; odd K = 173 spans two k-steps, the last ragged

#: rung -> (activation dtype, weight bits, int8 activations, tolerance)
RUNGS = {
    "float32*int8": ("float32", 8, False, 1e-4),
    "bfloat16*int8": ("bfloat16", 8, False, 2e-2),
    "int8*int8": ("float32", 8, True, 1e-4),
    "float32*int4": ("float32", 4, False, 1e-4),
    "int8*int4": ("float32", 4, True, 1e-4),
}


def _np_bytes(t):
    return t.numpy().tobytes() if isinstance(t, torch.Tensor) else np.asarray(t).tobytes()


# ---------------------------------------------------------------------------
# core.quant: byte-identical codes and scales
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(300, 200), (301, 130), (3, 65, 40)],
                         ids=["even_k", "odd_k", "stacked"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_weight_codes_and_scales_are_byte_identical(shape, bits):
    w = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    want = jq.quantize_weight(jnp.asarray(w), bits=bits)
    got = tq.quantize_weight(torch.from_numpy(w), bits=bits)
    assert got.values.dtype == torch.int8 and got.scales.dtype == torch.float32
    assert tuple(got.values.shape) == want.values.shape and got.shape == want.shape
    assert got.k == want.k and got.bits == want.bits == bits
    assert _np_bytes(got.values) == _np_bytes(want.values)
    assert _np_bytes(got.scales) == _np_bytes(want.scales)
    np.testing.assert_array_equal(got.dequantize().numpy(), np.asarray(want.dequantize()))


def test_quantize_weight_from_bf16_is_byte_identical():
    w = np.random.default_rng(2).normal(size=(2, 96, 64)).astype(np.float32)
    want = jq.quantize_weight(jnp.asarray(w, jnp.bfloat16), act_bits=8)
    got = tq.quantize_weight(torch.from_numpy(w).to(torch.bfloat16), act_bits=8)
    assert got.act_bits == want.act_bits == 8
    assert _np_bytes(got.values) == _np_bytes(want.values)
    assert _np_bytes(got.scales) == _np_bytes(want.scales)


def test_quantize_activations_is_byte_identical():
    x = np.random.default_rng(3).normal(size=(2, 7, 96)).astype(np.float32) * 3
    x[0, 0] = 0.0  # an all-zero row takes the 1e-8 floor
    want_q, want_s = jq.quantize_activations(jnp.asarray(x))
    got_q, got_s = tq.quantize_activations(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and tuple(got_s.shape) == (2, 7)
    assert _np_bytes(got_q) == _np_bytes(want_q) and _np_bytes(got_s) == _np_bytes(want_s)


@pytest.mark.parametrize("k", [10, 11])
def test_pack_and_unpack_int4_match_repro(k):
    q = np.random.default_rng(4).integers(-8, 8, size=(2, k, 33)).astype(np.int8)
    want = jq.pack_int4(jnp.asarray(q))
    got = tq.pack_int4(torch.from_numpy(q))
    assert _np_bytes(got) == _np_bytes(want) and tuple(got.shape) == (2, (k + 1) // 2, 33)
    back = tq.unpack_int4(got)
    assert _np_bytes(back) == _np_bytes(jq.unpack_int4(want))
    np.testing.assert_array_equal(back[:, :k].numpy(), q)
    if k % 2:
        assert not back[:, k:].any()  # the odd-K pad nibble is zero


def test_quantized_tensor_indexes_values_and_scales_together():
    w = torch.from_numpy(np.random.default_rng(5).normal(size=(3, 9, 16)).astype(np.float32))
    q = tq.quantize_weight(w, bits=4)
    layer = q[1]
    assert isinstance(layer, tq.QuantizedTensor) and layer.shape == (9, 16)
    assert layer.bits == 4 and layer.k == 9
    assert torch.equal(layer.values, q.values[1]) and torch.equal(layer.scales, q.scales[1])
    np.testing.assert_array_equal(layer.dequantize().numpy(), q.dequantize()[1].numpy())
    with pytest.raises(IndexError):
        layer[0]


@pytest.mark.parametrize("arch", ["granite-8b", "olmoe-1b-7b"])
@pytest.mark.parametrize("bits,act_bits", [(8, None), (8, 8), (4, None)],
                         ids=["int8", "int8-dynamic", "int4"])
def test_quantize_lm_params_converts_the_same_leaves(arch, bits, act_bits):
    _, jparams = _base_params(arch)
    rung = {(8, None): "int8", (8, 8): "int8-dynamic", (4, None): "int4"}[bits, act_bits]
    want, jn, jskip = _quantized_pair(arch, rung)[:3]  # repro's quantize_lm_params
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    got, n, skip = LM(get_reduced(arch)).quantize_weights(params, bits=bits, act_bits=act_bits)
    assert (n, skip) == (jn, jskip) and n > 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            want, is_leaf=lambda x: isinstance(x, jq.QuantizedTensor)):
        node = got
        for p in path:
            node = node[p.key]
        assert isinstance(node, tq.QuantizedTensor) == isinstance(leaf, jq.QuantizedTensor)
        if isinstance(leaf, jq.QuantizedTensor):
            assert (node.bits, node.act_bits, node.k) == (leaf.bits, leaf.act_bits, leaf.k)
            assert _np_bytes(node.values) == _np_bytes(leaf.values)
            assert _np_bytes(node.scales) == _np_bytes(leaf.scales)
    assert not isinstance(got["embed"], tq.QuantizedTensor)
    if arch == "olmoe-1b-7b":
        assert not isinstance(got["layers"]["moe"]["router"], tq.QuantizedTensor)


# ---------------------------------------------------------------------------
# B1-B3 (ops.gemm) and B5 plain versions against Pallas interpret
# ---------------------------------------------------------------------------


def _ladder_operands(m, n, k, rung, *, lead=(), seed=0):
    """(jax kwargs, torch kwargs) of one rung: the activations (int8 with
    their per-row scales for int8*int8), the weight values and scales, and
    b_bits — quantized by each package from the same numpy values."""
    act, bits, act_q, _ = RUNGS[rung]
    r = np.random.default_rng(seed)
    a = r.normal(size=(*lead, m, k)).astype(np.float32)
    w = r.normal(size=(*lead, k, n)).astype(np.float32)
    ja, ta = jnp.asarray(a, act), torch.from_numpy(a).to(getattr(torch, act))
    jw, tw = jq.quantize_weight(jnp.asarray(w), bits=bits), tq.quantize_weight(
        torch.from_numpy(w), bits=bits)
    jkw, tkw = dict(scale=jw.scales, b_bits=bits), dict(scale=tw.scales, b_bits=bits)
    if act_q:
        ja, jkw["scale_a"] = jq.quantize_activations(ja)
        ta, tkw["scale_a"] = tq.quantize_activations(ta)
    return (ja, jw.values, jkw), (ta, tw.values, tkw)


def _close(got, want, tol):
    np.testing.assert_allclose(
        got.to(torch.float32).numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol
    )


_SWEEP_WANT = {}


@pytest.mark.parametrize("rung", list(RUNGS))
@pytest.mark.parametrize("g", [4, 16])
@pytest.mark.parametrize("pol", range(len(ALL_POLICIES)), ids=[p.name for p in ALL_POLICIES])
def test_ops_gemm_plain_versions_match_pallas_interpret(pol, g, rung):
    """Each policy's composition of B1-B3 plain versions against repro's
    Stream-K kernels (ALL_SK, Pallas interpret) at the same grid size: every
    policy computes the same product, and one reference per (rung, g) keeps
    the jit traces few."""
    (ja, jb, jkw), (ta, tb, tkw) = _ladder_operands(*ODD, rung)
    if (rung, g) not in _SWEEP_WANT:
        _SWEEP_WANT[rung, g] = np.asarray(j_ops.gemm(
            ja, jb, policy=J_POLICIES[1], cfg=JTile(*CFG), g=g, interpret=True,
            out_dtype=jnp.float32, **jkw))
    got = ops.gemm(ta, tb, policy=ALL_POLICIES[pol], cfg=TileConfig(*CFG), g=g,
                   out_dtype=torch.float32, **tkw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (ODD[0], ODD[1])
    _close(got, _SWEEP_WANT[rung, g], RUNGS[rung][3])


@pytest.mark.parametrize("rung", list(RUNGS))
def test_ops_gemm_dequant_composes_with_epilogues(rung):
    """scale_a -> scale -> bias -> gelu -> residual add, DP and HYBRID."""
    m, n, k = ODD
    (ja, jb, jkw), (ta, tb, tkw) = _ladder_operands(m, n, k, rung, seed=6)
    r = np.random.default_rng(7)
    bias, operand = r.normal(size=(n,)).astype(np.float32), r.normal(size=(m, n)).astype(
        np.float32)
    spec = dict(activation="gelu", bias=True, binary="add")
    for pol in (0, 2):
        want = j_ops.gemm(ja, jb, policy=J_POLICIES[pol], cfg=JTile(*CFG), g=4, interpret=True,
                          out_dtype=jnp.float32, epilogue=JEpilogue(**spec),
                          bias=jnp.asarray(bias), operand=jnp.asarray(operand), **jkw)
        got = ops.gemm(ta, tb, policy=ALL_POLICIES[pol], cfg=TileConfig(*CFG), g=4,
                       out_dtype=torch.float32, epilogue=Epilogue(**spec),
                       bias=torch.from_numpy(bias), operand=torch.from_numpy(operand), **tkw)
        _close(got, want, RUNGS[rung][3])


@pytest.mark.parametrize("rung", list(RUNGS))
@pytest.mark.parametrize("pol", ["dp", "all_sk"])
def test_grouped_plain_version_matches_pallas_interpret(pol, rung):
    """3 experts of up to 20 rows (one empty, one ragged), K = 161 (odd,
    two k-steps), N = 200, with the swiglu-style mul_silu epilogue."""
    sizes = (17, 0, 20)
    (ja, jb, jkw), (ta, tb, tkw) = _ladder_operands(20, 200, 161, rung, lead=(3,), seed=8)
    operand = np.random.default_rng(9).normal(size=(3, 20, 200)).astype(np.float32)
    idx = [p.name for p in ALL_POLICIES].index(pol)
    want = j_grouped(ja, jb, policy=J_POLICIES[idx], cfg=JTile(*CFG), g=4, interpret=True,
                     out_dtype=jnp.float32, group_sizes=sizes,
                     epilogue=JEpilogue(binary="mul_silu"), operand=jnp.asarray(operand), **jkw)
    got = gemm_grouped_streamk(ta, tb, policy=ALL_POLICIES[idx], cfg=TileConfig(*CFG), g=4,
                               out_dtype=torch.float32, group_sizes=sizes,
                               epilogue=Epilogue(binary="mul_silu"),
                               operand=torch.from_numpy(operand), **tkw)
    plain = gemm_grouped_streamk_plain(ta, tb, sizes=sizes, out_dtype=torch.float32,
                                       epilogue=Epilogue(binary="mul_silu"),
                                       operand=torch.from_numpy(operand), bk=CFG[2], **tkw)
    _close(got, want, RUNGS[rung][3])
    assert torch.equal(got, plain) and not got[1].any() and not got[0, 17:].any()


def test_int8_x_int8_plain_versions_sum_each_k_step_in_order():
    """The int8 x int8 MAC adds each bk step's exact int32 product into the
    f32 sum in order, as the kernels do: the DP plain version and the
    Stream-K composition (whose split segments start on bk boundaries)
    agree bit for bit with that sum."""
    (_, _, _), (ta, tb, tkw) = _ladder_operands(*ODD, "int8*int8", seed=10)
    steps = [ta[:, k0:k0 + CFG[2]].to(torch.int64) @ tb[k0:k0 + CFG[2]].to(torch.int64)
             for k0 in range(0, ODD[2], CFG[2])]
    acc = steps[0].to(torch.float32)
    for s in steps[1:]:
        acc = acc + s.to(torch.float32)
    want = acc * tkw["scale_a"][:, None] * tkw["scale"][None, :]
    got = ops.gemm(ta, tb, policy=DP, cfg=TileConfig(*CFG), g=4, out_dtype=torch.float32, **tkw)
    assert torch.equal(got, want)


def test_rows_aligned_reads_each_operand_in_its_own_element_size():
    """An int8 B row of 24 bytes is not 16-byte aligned, though 24 f32
    elements (A's size) would be: the kernels must take the element-wise
    staging path for it."""
    from repro_torch.kernels.common import rows_aligned

    a = torch.zeros(4, 64)
    assert rows_aligned(a, torch.zeros(64, 32, dtype=torch.int8)) == 1
    assert rows_aligned(a, torch.zeros(64, 24, dtype=torch.int8)) == 0
    assert rows_aligned(torch.zeros(4, 40, dtype=torch.int8), torch.zeros(40, 32)) == 0


def test_int8_activations_x_int4_weights_raise_on_the_cpu_too():
    """int8 activations x packed int4 weights, once refused, now run on the
    CPU as on the card: the Stream-K++ composition (B1-B3), the DP and
    split-K baselines (B1, B6) and B5's wrapper agree with repro's Pallas
    interpret run at 1e-4."""
    (ja, jb, jkw), (ta, tb, tkw) = _ladder_operands(*ODD, "int8*int4", seed=11)
    assert ta.dtype == torch.int8 and tkw["b_bits"] == 4
    want = j_ops.gemm(ja, jb, policy=J_POLICIES[2], cfg=JTile(*CFG), g=4, interpret=True,
                      out_dtype=jnp.float32, **jkw)
    for got in (ops.gemm(ta, tb, policy=ALL_POLICIES[2], cfg=TileConfig(*CFG), g=4,
                         out_dtype=torch.float32, **tkw),
                dp_ops.gemm(ta, tb, cfg=TileConfig(*CFG), g=3, out_dtype=torch.float32, **tkw),
                splitk_ops.gemm(ta, tb, cfg=TileConfig(*CFG), s=2, out_dtype=torch.float32,
                                **tkw)):
        _close(got, want, 1e-4)
    gkw = dict(scale=tkw["scale"][None], scale_a=tkw["scale_a"][None], b_bits=4)
    want = j_grouped(ja[None], jb[None], cfg=JTile(*CFG), g=4, interpret=True,
                     out_dtype=jnp.float32, scale=jkw["scale"][None],
                     scale_a=jkw["scale_a"][None], b_bits=4)
    got = gemm_grouped_streamk(ta[None], tb[None], cfg=TileConfig(*CFG), g=4,
                               out_dtype=torch.float32, **gkw)
    _close(got, want, 1e-4)


# ---------------------------------------------------------------------------
# dispatch: op keys and selections
# ---------------------------------------------------------------------------


#: (M, N, K, G or None for a plain gemm, activation dtype, bits, act_bits)
DISPATCHES = [(4, 384, 256, None, "float32", 8, None), (33, 200, 301, None, "bfloat16", 4, None),
              (4, 512, 256, None, "float32", 8, 8), (4, 256, 128, 8, "bfloat16", 8, None),
              (16, 128, 256, 8, "float32", 4, None), (12, 200, 96, 3, "bfloat16", 8, 8)]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "loop"])
def test_quantized_dispatch_keys_and_selections_match_repro(fused):
    """The same quantized calls through both packages' dispatch (fresh
    default selectors, V5E cost model): equal op keys (the ``a*int8`` /
    ``int8*int8`` / ``a*int4`` fingerprints), tags and selections, and
    outputs within the rung's tolerance of repro's xla backend."""
    js, ts = JSelector(), KernelSelector()
    with j_gemm_mod.gemm_context(selector=js, backend="xla") as jctx, \
            gemm_context(selector=ts, backend="torch") as tctx:
        for i, (m, n, k, g, act, bits, act_bits) in enumerate(DISPATCHES):
            r = np.random.default_rng(20 + i)
            lead = () if g is None else (g,)
            x = r.normal(size=(*lead, m, k)).astype(np.float32)
            w = r.normal(size=(*lead, k, n)).astype(np.float32)
            jw = jq.quantize_weight(jnp.asarray(w), bits=bits, act_bits=act_bits)
            tw = tq.quantize_weight(torch.from_numpy(w), bits=bits, act_bits=act_bits)
            jx, tx = jnp.asarray(x, act), torch.from_numpy(x).to(getattr(torch, act))
            if g is None:
                want = j_gemm_mod.gemm(jx, jw, tag=f"t{i}")
                got = gemm(tx, tw, tag=f"t{i}")
            else:
                want = j_gemm_mod.gemm_grouped(jx, jw, tag=f"t{i}", fused=fused)
                got = gemm_grouped(tx, tw, tag=f"t{i}", fused=fused)
            assert got.dtype == getattr(torch, act)
            _close(got, want, 2e-2 if act == "bfloat16" else 1e-4)
    assert len(tctx.log) == len(jctx.log) == len(DISPATCHES)
    keys = {te.op.in_dtype for te in tctx.log}
    assert keys == {"float32*int8", "bfloat16*int4", "int8*int8", "bfloat16*int8",
                    "float32*int4"}
    for te, je in zip(tctx.log, jctx.log):
        assert te.op.key == je.op.key and te.tag == je.tag
        ts_, js_ = te.selection, je.selection
        assert (ts_.policy.name, ts_.cfg.name, ts_.g, ts_.source) == (
            js_.policy.name, js_.cfg.name, js_.g, js_.source)


# ---------------------------------------------------------------------------
# the reduced models, quantized, end to end
# ---------------------------------------------------------------------------

PROMPTS = [np.array(p, np.int32) for p in ([5, 17, 3, 99, 42, 7], list(range(30, 53)))]
LADDER = {"int8": (8, None), "int8-dynamic": (8, 8), "int4": (4, None)}
_MODELS = {}
_BASE = {}


def _base_params(arch):
    """repro's reduced f32 model and its seeded parameters, built once."""
    if arch not in _BASE:
        jmodel = JLM(dataclasses.replace(j_get_reduced(arch), dtype="float32"))
        _BASE[arch] = jmodel, materialize_tree(jmodel.param_specs(), jax.random.PRNGKey(0))
    return _BASE[arch]


def _quantized_pair(arch, rung):
    """repro's reduced f32 parameters quantized on ``rung`` (with the leaves
    converted and skipped), the port's model and copy of those parameters,
    and repro's prefill logits, greedy tokens and selection log (computed
    once per arch and rung)."""
    if (arch, rung) not in _MODELS:
        bits, act_bits = LADDER[rung]
        jmodel, base = _base_params(arch)
        jparams, n, skipped = jmodel.quantize_weights(base, bits=bits, act_bits=act_bits)
        params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
        with j_gemm_mod.gemm_context(backend="xla"):
            logits = [np.asarray(jmodel.prefill(jparams, jnp.asarray(p)[None], max_seq=48)[0])
                      for p in PROMPTS]
            jeng = JServeEngine(jmodel, jparams, JServeConfig(n_slots=2, max_seq=48, eos=-1))
            for p in PROMPTS:
                jeng.submit(p, max_new_tokens=5)
            tokens = {r.uid: r.out_tokens for r in jeng.run()}
        cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
        _MODELS[arch, rung] = (jparams, n, skipped, LM(cfg), params, logits, tokens,
                               jeng.selection_log)
    return _MODELS[arch, rung]


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("rung", list(LADDER))
@pytest.mark.parametrize("arch", ["granite-8b", "olmoe-1b-7b"])
def test_quantized_model_matches_repro(arch, rung, backend):
    _, n_quant, _, model, params, want_logits, want_tokens, jlog = _quantized_pair(arch, rung)
    assert n_quant > 0 and isinstance(params["lm_head"], tq.QuantizedTensor)
    for prompt, want in zip(PROMPTS, want_logits):
        with gemm_context(backend=backend, device="cpu"):
            got, _ = model.prefill(params, torch.from_numpy(prompt).long()[None], max_seq=48)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    eng = ServeEngine(model, params, ServeConfig(n_slots=2, max_seq=48, eos=-1),
                      backend=backend, device="cpu")
    for p in PROMPTS:
        eng.submit(p, max_new_tokens=5)
    done = {r.uid: r.out_tokens for r in eng.run()}
    assert len(done) == len(PROMPTS) and not eng.exhausted
    assert done == want_tokens
    # the selector saw the same quantized fingerprints, and picked the same
    # (repro logs a decode step's dispatches once, when jit traces it)
    def picks(log):
        return {(e.tag, e.op.key): (e.selection.policy.name, e.selection.cfg.name, e.selection.g)
                for e in log}

    assert picks(eng.selection_log) == picks(jlog)
    want_in = "int8*int8" if rung == "int8-dynamic" else f"float32*{rung}"
    assert {e.op.in_dtype for e in eng.selection_log if e.tag != "moe.router"} == {want_in}
