"""Parity of the MoE dispatch variants with the JAX package, in f32 on the CPU.

* ``moe_apply`` with ``moe_impl="sharded"`` (at ``div`` batch 1 and 4: one
  token group, and four routed each into its own capacity) and
  ``moe_impl="hinted"`` (token-major routing with the sharding hints) on
  reduced olmoe-1b-7b and qwen3-moe-235b-a22b, at a drop-free and a
  dropping capacity, against ``repro``'s ``moe_apply`` with the same
  ``moe_impl``: outputs within 1e-4 x max|want|, the aux loss within rtol
  1e-5, and the same dispatch keys and selections (``tests/test_torch_moe.py``'s
  tolerances). Both backends: ``torch`` and the kernels' plain versions.
* ``shard_map`` with no plan is the capacity (``global``) dispatch; under a
  one-rank plan it is ``repro``'s ``shard_map`` body on a one-device mesh,
  and ``shard_map_bf16`` its bf16 combine.
* The reduced models' prefill logits on each variant against ``repro``'s,
  and the variants serve the same greedy tokens as ``repro``'s engine.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.dist import sharding as j_sharding
from repro.dist.sharding import materialize_tree
from repro.models import build_model as j_build_model
from repro.models import layers as j_layers
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_reduced
from repro_torch.core.gemm import gemm_context
from repro_torch.dist import sharding
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model, layers
from repro_torch.models.lm import params_from_jax
from repro_torch.serve.engine import ServeConfig, ServeEngine

j_gemm_mod = importlib.import_module("repro.core.gemm")
ARCHS = ("olmoe-1b-7b", "qwen3-moe-235b-a22b")
#: (moe_impl, div): the variants against repro's own
VARIANTS = (("sharded", {}), ("sharded", {"batch": 4}), ("hinted", {}), ("hinted", {"batch": 4}))


def _cfgs(arch, **kw):
    jcfg = dataclasses.replace(j_get_reduced(arch), dtype="float32", **kw)
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32", **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _moe_inputs(cfg):
    r = np.random.default_rng(21)
    p = {name: (r.normal(size=s.shape) / np.sqrt(s.shape[-2])).astype(np.float32)
         for name, s in layers.moe_specs(cfg).items()}
    x = r.normal(size=(4, 10, cfg.d_model)).astype(np.float32)
    return p, x


def _run_pair(jcfg, cfg, p, x, div, backend="torch"):
    with j_gemm_mod.gemm_context(backend="xla") as jctx:
        want, want_aux = j_layers.moe_apply({k: jnp.asarray(v) for k, v in p.items()},
                                            jnp.asarray(x), jcfg, div=div)
    with gemm_context(backend=backend, device="cpu") as ctx:
        got, aux = layers.moe_apply({k: torch.from_numpy(v) for k, v in p.items()},
                                    torch.from_numpy(x), cfg, div=div)
    return (got, aux, ctx.log), (np.asarray(want), float(want_aux), jctx.log)


def _assert_close(got, aux, want, want_aux):
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(aux.item(), want_aux, rtol=1e-5)


def _keys(log):
    return [(e.tag, e.op.key, e.selection.policy.name, e.selection.cfg.name, e.selection.g)
            for e in log]


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("capacity_factor", [4.0, 0.5], ids=["drop_free", "dropping"])
@pytest.mark.parametrize("impl,div", VARIANTS, ids=[f"{i}-{d}" for i, d in VARIANTS])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_variant_matches_repro(arch, impl, div, capacity_factor, backend):
    jcfg, cfg = _cfgs(arch, moe_impl=impl, capacity_factor=capacity_factor)
    p, x = _moe_inputs(cfg)
    (got, aux, log), (want, want_aux, jlog) = _run_pair(jcfg, cfg, p, x, div, backend)
    _assert_close(got, aux, want, want_aux)
    assert _keys(log) == _keys(jlog)
    tags = [e.tag for e in log]
    if impl == "sharded":
        # the router is a plain einsum; the groups fold into the expert GEMMs' M
        assert tags == ["moe.gate", "moe.in", "moe.out"]
        groups = div.get("batch", 1)
        tl = x.shape[0] * x.shape[1] // groups
        cap = max(int(capacity_factor * tl * cfg.top_k / cfg.n_experts), min(tl, 16), 1)
        assert all(e.op.m == groups * cap and e.op.g == cfg.n_experts for e in log)
    else:
        assert tags == ["moe.router", "moe.gate", "moe.in", "moe.out"]


def test_sharded_groups_route_apart():
    """Four groups of 40 tokens at capacity factor 0.5 (16 rows an expert
    each, past the floor) differ from one group of 160 (20 rows): each group
    fills its own capacity; a count that does not divide is one group."""
    _, cfg = _cfgs("olmoe-1b-7b", moe_impl="sharded", capacity_factor=0.5)
    p, _ = _moe_inputs(cfg)
    p = {k: torch.from_numpy(v) for k, v in p.items()}
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(4, 40, cfg.d_model)).astype(
        np.float32))
    one, _ = layers.moe_apply(p, x, cfg, div={})
    four, _ = layers.moe_apply(p, x, cfg, div={"batch": 4})
    odd, _ = layers.moe_apply(p, x, cfg, div={"batch": 3})  # 160 % 3: one group
    assert not torch.equal(one, four) and torch.equal(one, odd)


@pytest.mark.parametrize("arch", ARCHS)
def test_shard_map_without_plan_is_the_capacity_dispatch(arch):
    _, cfg = _cfgs(arch, capacity_factor=0.5)
    p, x = _moe_inputs(cfg)
    p = {k: torch.from_numpy(v) for k, v in p.items()}
    want, want_aux = layers.moe_apply(p, torch.from_numpy(x), cfg, div={})
    for impl in ("shard_map", "shard_map_bf16"):
        got, aux = layers.moe_apply(p, torch.from_numpy(x),
                                    dataclasses.replace(cfg, moe_impl=impl), div={})
        assert torch.equal(got, want) and torch.equal(aux, want_aux)


@pytest.mark.parametrize("impl", ["shard_map", "shard_map_bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_shard_map_on_one_rank_matches_repro(arch, impl):
    """Under a one-rank plan: ``repro``'s ``shard_map`` body on a one-device
    (data, model) mesh."""
    jcfg, cfg = _cfgs(arch, moe_impl=impl, capacity_factor=0.5)
    p, x = _moe_inputs(cfg)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    with j_sharding.use_plan(j_sharding.ShardingPlan(jmesh)), \
            sharding.use_plan(sharding.ShardingPlan(make_host_mesh(1))):
        (got, aux, log), (want, want_aux, jlog) = _run_pair(jcfg, cfg, p, x, {})
    _assert_close(got, aux, want, want_aux)
    assert _keys(log) == _keys(jlog)
    assert [e.tag for e in log] == ["moe.gate", "moe.in", "moe.out"]


PROMPTS = [np.array(p, np.int32) for p in ([5, 17, 3, 99, 42, 7], [200, 1, 64], list(range(30, 53)))]


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    jcfg, cfg = _cfgs(request.param)
    jmodel = j_build_model(jcfg)
    jparams = materialize_tree(jmodel.param_specs(), jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, params


@pytest.mark.parametrize("impl", ["sharded", "hinted"])
def test_variant_models_prefill_and_serve_like_repro(models, impl):
    """The reduced model on each variant: prefill logits of each prompt
    within 1e-4 x max|logit| of ``repro``'s, and the engines' greedy tokens
    (2 slots, so the sharded decode routes 2 groups under div batch 2)."""
    jcfg, cfg, jparams, params = models
    jcfg, cfg = (dataclasses.replace(c, moe_impl=impl) for c in (jcfg, cfg))
    jmodel, model = j_build_model(jcfg), build_model(cfg)
    div = {"batch": 2, "model": 1}
    for prompt in PROMPTS:
        with j_gemm_mod.gemm_context(backend="xla"):
            want, _ = jmodel.prefill(jparams, jnp.asarray(prompt)[None], max_seq=48, div=div)
        got, _ = model.prefill(params, torch.from_numpy(prompt).long()[None], max_seq=48,
                               div=div)
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    jeng = JServeEngine(jmodel, jparams, JServeConfig(n_slots=2, max_seq=48, eos=-1), div=div)
    eng = ServeEngine(model, params, ServeConfig(n_slots=2, max_seq=48, eos=-1), div=div,
                      device="cpu")
    with j_gemm_mod.gemm_context(backend="xla"):
        for p in PROMPTS:
            jeng.submit(p, max_new_tokens=5)
        jdone = {r.uid: r.out_tokens for r in jeng.run()}
    for p in PROMPTS:
        eng.submit(p, max_new_tokens=5)
    done = {r.uid: r.out_tokens for r in eng.run()}
    assert len(done) == 3 and done == jdone
