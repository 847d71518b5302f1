"""Parity of the port's MoE slice with the JAX package.

* B5's plain version, and its wrapper on CPU tensors, against
  ``repro.kernels.streamk.grouped.gemm_grouped_streamk`` in Pallas interpret
  mode, across policies, grid sizes, ragged group sizes (empty groups and
  all-empty included), dtypes and epilogues. Tolerances (docs/kernels.md):
  1e-4 for f32 (f32 sums in another order), 2e-2 for bf16 (one bf16
  rounding of the output).
* ``gemm_grouped``: the same calls log the same op keys and selections as
  ``repro``'s, fused and loop form alike.
* ``moe_apply`` against ``repro``'s on the same numpy inputs, in f32.
* Reduced olmoe-1b-7b in f32 with ``repro``'s parameters carried across:
  exact parameters, prefill logits within 1e-4 x max|logit|, and the same
  greedy tokens as ``repro``'s ``ServeEngine`` through the ``torch`` and
  ``cuda`` backends (the kernels' plain versions on CPU tensors).

The CUDA kernel itself runs only on the card: ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` hold it against the plain version there.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.core.op import Epilogue as JEpilogue
from repro.core.policies import ALL_POLICIES as J_POLICIES
from repro.core.policies import TileConfig as JTile
from repro.core.selector import KernelSelector as JSelector
from repro.dist.sharding import materialize_tree
from repro.kernels.streamk.grouped import gemm_grouped_streamk as j_grouped
from repro.models import layers as j_layers
from repro.models.lm import LM as JLM
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config, get_reduced
from repro_torch.core.gemm import gemm_context, gemm_grouped
from repro_torch.core.op import Epilogue
from repro_torch.core.policies import ALL_POLICIES, TileConfig
from repro_torch.core.selector import KernelSelector
from repro_torch.kernels import common
from repro_torch.kernels.streamk.grouped import (
    gemm_grouped_streamk,
    gemm_grouped_streamk_plain,
    row_block_table,
)
from repro_torch.models import layers
from repro_torch.models.lm import LM, params_from_jax
from repro_torch.serve.engine import ServeConfig, ServeEngine

j_gemm_mod = importlib.import_module("repro.core.gemm")  # repro.core re-exports gemm()
CFG = (8, 128, 128)  # the small tile of tests/test_grouped_streamk.py
POL = {p.name: i for i, p in enumerate(ALL_POLICIES)}
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4), "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
EPILOGUES = {
    "none": dict(),
    "gelu": dict(activation="gelu"),
    "bias": dict(bias=True),
    "mul_silu": dict(binary="mul_silu"),
}


def _grouped_inputs(g, m, n, k, dname, seed=0):
    """The same values for both packages (bf16 rounded identically)."""
    r = np.random.default_rng(seed)
    xs = (
        r.normal(size=(g, m, k)).astype(np.float32),
        (r.normal(size=(g, k, n)) / np.sqrt(k)).astype(np.float32),
        r.normal(size=(g, n)).astype(np.float32),
        r.normal(size=(g, m, n)).astype(np.float32),
    )
    jdt, tdt, _ = DTYPES[dname]
    return [jnp.asarray(x, jdt) for x in xs], [torch.from_numpy(x).to(tdt) for x in xs]


def _close(got, want, tol):
    np.testing.assert_allclose(
        got.to(torch.float32).numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol
    )


#: (policy, g, group sizes, dtype, epilogue); 3 groups of up to 20 rows,
#: K = 160 (two k-iterations, the second ragged), N = 200 (two ragged tiles)
GROUPED_CASES = (
    [(pol, g, (20, 20, 20), "f32", "none") for pol in ("dp", "all_sk", "sk1dp") for g in (2, 8)]
    + [("all_sk", 4, sizes, dname, "none") for sizes in ((17, 3, 20), (20, 0, 5), (0, 0, 11))
       for dname in ("f32", "bf16")]
    + [(pol, 4, (17, 0, 20), dname, epi) for pol in ("dp", "all_sk")
       for dname in ("f32", "bf16") for epi in ("gelu", "bias", "mul_silu")]
)


@pytest.mark.parametrize("pol,g,sizes,dname,epi", GROUPED_CASES,
                         ids=["-".join(map(str, c)) for c in GROUPED_CASES])
def test_grouped_matches_jax(pol, g, sizes, dname, epi):
    (ja, jb, jbias, jop), (ta, tb, tbias, top_) = _grouped_inputs(3, 20, 200, 160, dname)
    _, tdt, tol = DTYPES[dname]
    spec = EPILOGUES[epi]
    jkw, tkw = dict(epilogue=JEpilogue(**spec)), dict(epilogue=Epilogue(**spec))
    if spec.get("bias"):
        jkw["bias"], tkw["bias"] = jbias, tbias
    if spec.get("binary"):
        jkw["operand"], tkw["operand"] = jop, top_
    want = j_grouped(ja, jb, policy=J_POLICIES[POL[pol]], cfg=JTile(*CFG), g=g, interpret=True,
                     group_sizes=sizes, **jkw)
    got = gemm_grouped_streamk(ta, tb, policy=ALL_POLICIES[POL[pol]], cfg=TileConfig(*CFG), g=g,
                               group_sizes=sizes, **tkw)
    plain = gemm_grouped_streamk_plain(ta, tb, sizes=sizes, out_dtype=tdt, **tkw)
    assert got.dtype == plain.dtype == tdt and got.shape == (3, 20, 200)
    _close(got, want, tol)
    _close(plain, want, tol)
    for i, s in enumerate(sizes):
        assert not got[i, s:].any()


def test_grouped_all_empty_launches_nothing():
    (ja, jb, _, _), (ta, tb, _, _) = _grouped_inputs(2, 8, 128, 128, "f32")
    want = j_grouped(ja, jb, cfg=JTile(*CFG), interpret=True, group_sizes=(0, 0))
    common.reset_launch_counts()
    with common.count_launches() as log:
        got = gemm_grouped_streamk(ta, tb, cfg=TileConfig(*CFG), group_sizes=(0, 0))
    assert log == [] and sum(common.LAUNCHES.values()) == 0
    assert got.shape == (2, 8, 128) and not got.any() and not np.asarray(want).any()


def test_row_block_table_concatenates_live_row_blocks():
    """Group i owns ceil(sizes[i] / bm) row-blocks, in group order, each
    ending at the group's size; empty groups own none."""
    tab = row_block_table((17, 0, 20, 3), 8)
    assert tab.dtype == np.int32
    assert tab.tolist() == [[0, 0, 8], [0, 8, 16], [0, 16, 17], [2, 0, 8], [2, 8, 16],
                            [2, 16, 20], [3, 0, 3]]
    assert row_block_table((0, 0), 8).shape == (0, 3)


@pytest.mark.parametrize("kw", [dict(scale=torch.ones(3, 200)), dict(scale_a=torch.ones(3, 20)),
                                dict()], ids=["scale", "scale_a", "int4"])
def test_grouped_quantized_arguments_raise(kw):
    """int8 activations against packed int4 expert weights, once refused,
    now run: B5's wrapper (both forms, ragged sizes) against repro's
    grouped kernel in Pallas interpret mode, with or without the scales."""
    _, (ta, tb, _, _) = _grouped_inputs(3, 20, 200, 160, "f32")
    a = (ta.numpy() * 4).astype(np.int8)
    b = (tb.numpy() * 40).astype(np.int8)[:, :80]  # 80 packed rows = K 160
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), torch.from_numpy(a), torch.from_numpy(b)
    kw = {name: v * torch.linspace(0.5, 1.5, v.shape[-1]) for name, v in kw.items()}
    jkw = {name: jnp.asarray(v.numpy()) for name, v in kw.items()}
    for pol in ("dp", "all_sk"):
        want = j_grouped(ja, jb, policy=J_POLICIES[POL[pol]], cfg=JTile(*CFG), g=4,
                         interpret=True, out_dtype=jnp.float32, group_sizes=(17, 0, 20),
                         b_bits=4, **jkw)
        got = gemm_grouped_streamk(ta, tb, policy=ALL_POLICIES[POL[pol]], cfg=TileConfig(*CFG),
                                   g=4, out_dtype=torch.float32, group_sizes=(17, 0, 20),
                                   b_bits=4, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
        assert got.abs().max() > 0 and not got[1].any()


#: (M, N, K, G, dtype, epilogue) of the grouped dispatches below: 64
#: experts at decode (M = 4) and prompt (M = 16) capacity, narrowed in K and
#: N to keep the inputs cheap, and a ragged 3-group shape
DISPATCHES = [(4, 256, 512, 64, "bfloat16", "none"), (4, 256, 512, 64, "bfloat16", "mul_silu"),
              (16, 512, 256, 64, "float32", "none"), (12, 200, 96, 3, "float32", "bias"),
              (12, 200, 96, 3, "float32", "gelu")]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "loop"])
def test_gemm_grouped_keys_and_selections_match_repro(fused):
    """The same grouped calls through both packages' dispatch (fresh
    default selectors, V5E cost model): equal op keys, tags and selections,
    and outputs within tolerance."""
    js, ts = JSelector(), KernelSelector()
    with j_gemm_mod.gemm_context(selector=js, backend="xla") as jctx, \
            gemm_context(selector=ts, backend="torch") as tctx:
        for i, (m, n, k, g, dt, epi) in enumerate(DISPATCHES):
            dname = "bf16" if dt == "bfloat16" else "f32"
            (jx, jw, jbias, jop), (tx, tw, tbias, top_) = _grouped_inputs(g, m, n, k, dname, seed=i)
            spec = EPILOGUES[epi]
            jkw, tkw = dict(epilogue=JEpilogue(**spec)), dict(epilogue=Epilogue(**spec))
            if spec.get("bias"):  # a (N,) bias broadcasts over the groups
                jkw["bias"], tkw["bias"] = jbias[0], tbias[0]
            if spec.get("binary"):
                jkw["operand"], tkw["operand"] = jop, top_
            want = j_gemm_mod.gemm_grouped(jx, jw, tag=f"t{i}", fused=fused, **jkw)
            got = gemm_grouped(tx, tw, tag=f"t{i}", fused=fused, **tkw)
            _close(got, want, DTYPES[dname][2])
    assert len(tctx.log) == len(jctx.log) == len(DISPATCHES)
    for te, je in zip(tctx.log, jctx.log):
        assert te.op.key == je.op.key and te.tag == je.tag
        assert len(te.op.key) == (8 if fused else 7)
        ts_, js_ = te.selection, je.selection
        assert (ts_.policy.name, ts_.cfg.name, ts_.g, ts_.source) == (
            js_.policy.name, js_.cfg.name, js_.g, js_.source)


def test_fused_and_loop_forms_agree_through_the_cuda_backend():
    """On CPU tensors the cuda backend runs B5's plain version (fused) or
    the per-group policy composition (loop); the two agree."""
    _, (tx, tw, _, top_) = _grouped_inputs(3, 12, 200, 96, "f32", seed=7)
    with gemm_context(backend="cuda", device="cpu"):
        fused = gemm_grouped(tx, tw, epilogue=Epilogue(binary="mul_silu"), operand=top_)
        loop = gemm_grouped(tx, tw, epilogue=Epilogue(binary="mul_silu"), operand=top_,
                            fused=False)
    _close(fused, loop.numpy(), 1e-4)


# ---------------------------------------------------------------------------
# moe_apply and the served slice
# ---------------------------------------------------------------------------


def _moe_pair(capacity_factor):
    jcfg = dataclasses.replace(j_get_reduced("olmoe-1b-7b"), dtype="float32",
                               capacity_factor=capacity_factor)
    cfg = dataclasses.replace(get_reduced("olmoe-1b-7b"), dtype="float32",
                              capacity_factor=capacity_factor)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    r = np.random.default_rng(11)
    spec = layers.moe_specs(cfg)
    p = {name: (r.normal(size=s.shape) / np.sqrt(s.shape[-2])).astype(np.float32)
         for name, s in spec.items()}
    return jcfg, cfg, p


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("capacity_factor", [4.0, 0.5], ids=["drop_free", "dropping"])
def test_moe_apply_matches_repro(capacity_factor, backend):
    """40 tokens, 8 experts, top-2: at capacity factor 0.5 the capacity is
    16 and some assignments land in the trash column."""
    jcfg, cfg, p = _moe_pair(capacity_factor)
    x = np.random.default_rng(12).normal(size=(2, 20, cfg.d_model)).astype(np.float32)
    with j_gemm_mod.gemm_context(backend="xla"):
        want, want_aux = j_layers.moe_apply({k: jnp.asarray(v) for k, v in p.items()},
                                            jnp.asarray(x), jcfg, div={})
    with gemm_context(backend=backend, device="cpu") as ctx:
        got, aux = layers.moe_apply({k: torch.from_numpy(v) for k, v in p.items()},
                                    torch.from_numpy(x), cfg, div={})
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-5)
    assert [e.tag for e in ctx.log] == ["moe.router", "moe.gate", "moe.in", "moe.out"]
    assert all(e.op.fused and e.op.g == 8 for e in ctx.log[1:])


def test_moe_apply_refuses_the_mesh_variants():
    """``sharded`` and ``hinted`` run on one rank (``tests/test_torch_moe_variants.py``);
    ``shard_map`` under a plan whose mesh spans more than one rank needs the
    multi-rank slice and says so, and an unknown variant is refused."""
    from types import SimpleNamespace

    from repro_torch.dist.sharding import ShardingPlan, use_plan

    _, cfg, p = _moe_pair(4.0)
    x = torch.zeros(1, 2, cfg.d_model)
    p = {k: torch.from_numpy(v) for k, v in p.items()}
    mesh = SimpleNamespace(shape={"data": 2, "model": 4}, axis_names=("data", "model"))
    for impl in ("shard_map", "shard_map_bf16"):
        with use_plan(ShardingPlan(mesh)), pytest.raises(NotImplementedError,
                                                         match="multi-rank slice"):
            layers.moe_apply(p, x, dataclasses.replace(cfg, moe_impl=impl), div={})
    with pytest.raises(ValueError, match="moe_impl"):
        layers.moe_apply(p, x, dataclasses.replace(cfg, moe_impl="ring"), div={})


PROMPTS = [np.array(p, np.int32) for p in ([5, 17, 3, 99, 42, 7], [200, 1, 64], list(range(30, 53)))]


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(j_get_reduced("olmoe-1b-7b"), dtype="float32")
    cfg = dataclasses.replace(get_reduced("olmoe-1b-7b"), dtype="float32")
    jmodel = JLM(jcfg)
    jparams = materialize_tree(jmodel.param_specs(), jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, LM(cfg), params


def test_moe_params_carry_across_exactly(pair):
    """The stacked (L, E, K, N) expert leaves and the f32 router included."""
    jmodel, jparams, model, params = pair
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)

    def count(tree):
        return sum(count(v) for v in tree.values()) if isinstance(tree, dict) else 1

    assert count(params) == count(model.param_specs()) == len(flat_j)
    for path, leaf in flat_j:
        node = params
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == leaf.shape and str(node.dtype).endswith(str(leaf.dtype))
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    moe = params["layers"]["moe"]
    cfg = model.cfg
    assert tuple(moe["w_in"].shape) == (cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff)
    assert moe["router"].dtype == torch.float32


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_moe_prefill_logits_match_repro(pair, backend):
    jmodel, jparams, model, params = pair
    for prompt in PROMPTS:
        want, _ = jmodel.prefill(jparams, jnp.asarray(prompt)[None], max_seq=48)
        with gemm_context(backend=backend, device="cpu"):
            got, _ = model.prefill(params, torch.from_numpy(prompt).long()[None], max_seq=48)
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_moe_serve_engine_greedy_tokens_identical(pair, backend):
    jmodel, jparams, model, params = pair
    jeng = JServeEngine(jmodel, jparams, JServeConfig(n_slots=2, max_seq=48, eos=-1))
    eng = ServeEngine(model, params, ServeConfig(n_slots=2, max_seq=48, eos=-1),
                      backend=backend, device="cpu")
    with j_gemm_mod.gemm_context(backend="xla"):
        for p in PROMPTS:
            jeng.submit(p, max_new_tokens=6)
        jdone = {r.uid: r.out_tokens for r in jeng.run()}
    for p in PROMPTS:
        eng.submit(p, max_new_tokens=6)
    done = {r.uid: r.out_tokens for r in eng.run()}
    assert len(done) == 3 and not eng.exhausted
    assert done == jdone
    tags = {e.tag for e in eng.selection_log}
    assert tags == {"attn.q", "attn.k", "attn.v", "attn.o", "moe.router", "moe.gate", "moe.in",
                    "moe.out", "lm_head"}


def test_full_olmoe_config_is_the_published_width():
    cfg = get_config("olmoe-1b-7b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size,
            cfg.n_experts, cfg.top_k) == (16, 2048, 16, 16, 1024, 50304, 64, 8)
    assert cfg.dtype == "bfloat16" and cfg.mlp_act == "swiglu" and cfg.family == "moe"
    specs = LM(cfg).param_specs()
    n = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(
        specs, is_leaf=lambda s: hasattr(s, "shape")))
    assert 6.8e9 < n < 7.0e9  # about 6.92 B parameters
