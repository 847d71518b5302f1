"""The port across ``torch.distributed`` ranks against ``repro`` on one
device, on the CPU: ``gloo`` ranks started by ``torch.multiprocessing``
over a file rendezvous (``tests/test_torch_multirank_ranks.py`` holds what
each rank runs), every group under a 60 s timeout and the join under its
own, so a hang fails its test. One group of 2 ranks and one of 4 serve all
the cases; the same numpy inputs from a seed go to ``repro`` (xla, one
device) in this process. Reduced configs in f32.

* granite-8b on (1, 2) and (1, 4) (its 2 kv heads split inside a head on
  4 ranks: the demoted path): prefill logits and a greedy decode chain
  within 1e-4 x max|logit| of ``repro``'s, the engine's greedy tokens equal
  to ``repro``'s engine, each rank's ``tag:local_mnk`` keys equal to the
  one-rank plan's (``serve_gemm_div``) and the dry run's.
* olmoe-1b-7b's MoE layer on ``shard_map`` and ``shard_map_bf16`` on
  (1, 2) and (2, 2) against ``repro``'s body on a one-device plan applied
  to each data row's tokens (1e-4; the bf16 combine 2e-2), B5 at G = E /
  model.
* Elastic training of granite-8b: 3 steps on (4, 1), checkpointed, resumed
  for 3 on (2, 2) and on (1, 4); the losses within 1e-4 of ``repro``'s
  one-device ``Trainer`` on the same data, and each mesh's first-step
  gradient leaves, gathered whole, within 1e-4 x max|g| of ``jax.grad``;
  the parameters' shard/gather round trip exact.
* Collectives: the dry run's virtual record of a decode step on (1, 2) and
  of a train step on (2, 2) equal to what the ``gloo`` ranks recorded, op
  by op in count and bytes; the (1, 2) decode step also equal to a hand
  count. The public reduce-scatter and all-to-all on (2, 2), forward and
  backward, equal to numpy's exchange of the ranks' inputs.
* The ranked ``constrain`` check and the virtual collectives in-process.
"""

import dataclasses
import functools
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_multirank_ranks as ranks
from repro.configs import get_reduced as j_get_reduced
from repro.core.gemm import gemm_context as j_gemm_context
from repro.data import SyntheticLMData as JData
from repro.dist import sharding as j_sharding
from repro.dist.sharding import materialize_tree
from repro.models import build_model as j_build_model
from repro.models import layers as j_layers
from repro.optim import make_optimizer as j_make_optimizer
from repro.optim import warmup_cosine as j_warmup_cosine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import init_train_state as j_init_train_state
from repro_torch.core.gemm import gemm_context
from repro_torch.dist import collectives, sharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshShape, virtual_mesh
from repro_torch.models import build_model, layers
from repro_torch.models.lm import params_from_jax
from repro_torch.serve.engine import serve_gemm_div
from repro_torch.utils.trees import tree_items

pytestmark = pytest.mark.skipif(not torch.distributed.is_gloo_available(),
                                reason="torch.distributed without gloo")

PROMPTS = [np.array(p, np.int32) for p in ([5, 17, 3, 99, 42, 7], [200, 1, 64],
                                           list(range(30, 53)))]
F32 = {"dtype": "float32"}


@functools.lru_cache(maxsize=None)
def _granite():
    jcfg = dataclasses.replace(j_get_reduced("granite-8b"), **F32)
    jmodel = j_build_model(jcfg)
    jparams = jax.tree.map(np.asarray, materialize_tree(jmodel.param_specs(),
                                                        jax.random.PRNGKey(0)))
    return jcfg, jmodel, jparams


def _moe_inputs():
    cfg = ranks.f32_reduced("olmoe-1b-7b")
    r = np.random.default_rng(21)
    p = {name: (r.normal(size=s.shape) / np.sqrt(s.shape[-2])).astype(np.float32)
         for name, s in layers.moe_specs(cfg).items()}
    return p, r.normal(size=(4, 10, cfg.d_model)).astype(np.float32)


def _tokens():
    return np.random.default_rng(3).integers(1, 256, ranks.GRANITE_TOKENS_SHAPE)


def _group(tmp_path_factory, program, world):
    workdir = tmp_path_factory.mktemp(program.__name__)
    inputs = {"granite": _granite()[2], "granite_tokens": _tokens(), "prompts": PROMPTS,
              "moe": _moe_inputs()}
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    return ranks.run_ranks(program, world, workdir, timeout=240)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _group(tmp_path_factory, ranks.program_two, 2)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _group(tmp_path_factory, ranks.program_four, 4)


@pytest.fixture(params=["1x2", "1x4"])
def served(request, two, four):
    n = int(request.param[-1])
    return n, [r["serve"] for r in (two if n == 2 else four).values()]


# -- dense serving ---------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _repro_chain():
    _, jmodel, jparams = _granite()
    tokens = jnp.asarray(_tokens())
    with j_gemm_context(backend="xla"):
        logits, cache = jmodel.prefill(jparams, tokens, max_seq=ranks.CACHE_SEQ)
        chain = [np.asarray(logits)]
        pos = jnp.full((tokens.shape[0],), tokens.shape[1])
        for _ in range(ranks.DECODE_STEPS):
            nxt = jnp.argmax(logits[:, -1], axis=-1)[:, None]
            logits, cache = jmodel.decode_step(jparams, cache, nxt, pos)
            chain.append(np.asarray(logits))
            pos = pos + 1
    return chain


def test_dense_logits_match_repro(served):
    _, per_rank = served
    want = _repro_chain()
    for out in per_rank:
        assert len(out["chain"]) == len(want)
        for got, ref in zip(out["chain"], want):
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_greedy_tokens_match_repros_engine(served):
    _, per_rank = served
    _, jmodel, jparams = _granite()
    jeng = JServeEngine(jmodel, jparams, JServeConfig(n_slots=ranks.ENGINE_SLOTS,
                                                      max_seq=ranks.ENGINE_SEQ, eos=-1))
    with j_gemm_context(backend="xla"):
        for p in PROMPTS:
            jeng.submit(p, max_new_tokens=ranks.ENGINE_NEW)
        want = {r.uid: r.out_tokens for r in jeng.run()}
    assert len(want) == len(PROMPTS)
    for out in per_rank:
        assert out["tokens"] == want


def _one_rank_plan_keys(n):
    """The keys of the same prefill and decode chain in one process under a
    device-free (1, n) plan: full tensors, ``serve_gemm_div``'s divisors."""
    cfg = ranks.f32_reduced("granite-8b")
    model = build_model(cfg)
    params = params_from_jax(_granite()[2], device="cpu")
    tokens = torch.as_tensor(_tokens()).long()
    with sharding.use_plan(sharding.ShardingPlan(MeshShape((1, n), ("data", "model")))), \
            torch.no_grad():
        div = serve_gemm_div(model)
        assert div == {"batch": 1, "model": n}
        with gemm_context(device="cpu") as ctx:
            logits, cache = model.prefill(params, tokens, max_seq=ranks.CACHE_SEQ, div=div)
        prefill = ranks.dispatch_keys(ctx.log)
        pos = torch.full((tokens.shape[0],), tokens.shape[1])
        with gemm_context(device="cpu") as ctx:
            model.decode_step(params, cache, tokens[:, :1], pos, div=div)
    return prefill, ranks.dispatch_keys(ctx.log)


def _dry(shape, mesh, batch, seq, arch="granite-8b"):
    """The dry run of the reduced f32 config's cell on a host mesh, under
    the rules the ranks run (the default ones)."""
    return dryrun.lower_cell(arch, shape, False, mesh_shape=mesh,
                             extra_rules=dict(sharding.DEFAULT_RULES),
                             config_overrides=dataclasses.asdict(ranks.f32_reduced(arch)),
                             shape_overrides={"global_batch": batch, "seq_len": seq})


def test_dispatch_keys_equal_the_one_rank_plan_and_the_dry_run(served):
    n, per_rank = served
    prefill, decode = _one_rank_plan_keys(n)
    b, s = ranks.GRANITE_TOKENS_SHAPE
    dry_prefill = sorted(_dry("prefill_32k", (1, n), b, s)["dispatch"])
    dry_decode = sorted(_dry("decode_32k", (1, n), b, ranks.CACHE_SEQ)["dispatch"])
    assert prefill == dry_prefill and decode == dry_decode
    for out in per_rank:
        assert out["prefill_keys"] == prefill
        assert out["decode_keys"] == decode
    # (1, 4): the 2 kv heads do not divide the axis, so the caches hold both
    assert [out["kv_cache_heads"] for out in per_rank] == [1 if n == 2 else 2] * n


# -- the MoE layer --------------------------------------------------------------------


def _repro_rows(impl, x_rows):
    jcfg = dataclasses.replace(j_get_reduced("olmoe-1b-7b"), moe_impl=impl,
                               capacity_factor=0.5, **F32)
    p, _ = _moe_inputs()
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    with j_sharding.use_plan(j_sharding.ShardingPlan(jmesh)), j_gemm_context(backend="xla"):
        y, aux = j_layers.moe_apply({k: jnp.asarray(v) for k, v in p.items()},
                                    jnp.asarray(x_rows), jcfg, div={})
    return np.asarray(y), float(aux)


@pytest.mark.parametrize("impl,tol", [("shard_map", 1e-4), ("shard_map_bf16", 2e-2)])
@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_moe_shard_map_matches_repros_body_per_data_row(two, four, mesh, impl, tol):
    data = int(mesh[0])
    _, x = _moe_inputs()
    rows = x.shape[0] // data
    group = two if mesh == "1x2" else four
    for out in group.values():
        moe = out["moe"]
        d = moe["coords"]["data"]
        want, want_aux = _repro_rows(impl, x[d * rows:(d + 1) * rows])
        got = moe[impl]
        np.testing.assert_allclose(got["y"], want, rtol=0, atol=tol * np.abs(want).max())
        np.testing.assert_allclose(got["aux"], want_aux, rtol=1e-5)
        # B5 at G = E / model on each of the three grouped projections
        assert got["groups"] == [8 // 2] * 3


# -- elastic training -------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _repro_history():
    jcfg, jmodel, jparams = _granite()
    opt = j_make_optimizer("adamw", j_warmup_cosine(3e-3, 2, 2 * ranks.TRAIN_STEPS))
    t = JTrainer(jmodel, opt, JData(jcfg, batch=ranks.TRAIN_BATCH, seq_len=ranks.TRAIN_SEQ,
                                    seed=1),
                 JTrainerConfig(total_steps=2 * ranks.TRAIN_STEPS, log_every=100,
                                ckpt_every=100))
    t.fit(j_init_train_state(jmodel, opt, jax.tree.map(jnp.asarray, jparams)))
    return t.history


@pytest.mark.parametrize("resumed_on", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_elastic_losses_match_repros_one_device_trainer(four, resumed_on):
    want = _repro_history()
    k = ranks.TRAIN_STEPS
    for out in four.values():
        hist = out["train"]["history"]
        np.testing.assert_allclose(hist[(4, 1)], want[:k], rtol=1e-4)
        np.testing.assert_allclose(hist[resumed_on], want[k:], rtol=1e-4)


@functools.lru_cache(maxsize=None)
def _repro_grads():
    jcfg, jmodel, jparams = _granite()
    batch = JData(jcfg, batch=ranks.TRAIN_BATCH, seq_len=ranks.TRAIN_SEQ, seed=1).batch_at(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with j_gemm_context():
        grads = jax.grad(lambda p: jmodel.loss_fn(p, jb)[0])(jax.tree.map(jnp.asarray,
                                                                          jparams))
    return dict(tree_items(jax.tree.map(np.asarray, grads)))


@pytest.mark.parametrize("mesh", [(4, 1), (2, 2), (1, 4)], ids=["4x1", "2x2", "1x4"])
def test_first_step_gradients_gathered_match_jax_grad(four, mesh):
    want = _repro_grads()
    got = dict(tree_items(four[0]["train"]["grads"][mesh]))
    assert sorted(got) == sorted(want)
    for name, ref in want.items():
        # a wrong backward of a collective is off by a whole factor (x W)
        np.testing.assert_allclose(got[name], ref, rtol=0,
                                   atol=1e-4 * max(np.abs(ref).max(), 1e-30), err_msg=name)
    # the norm the train step sums across ranks, each replicated leaf once
    norm = np.sqrt(sum(np.square(g.astype(np.float64)).sum() for g in want.values()))
    for out in four.values():
        np.testing.assert_allclose(out["train"]["norms"][mesh], norm, rtol=1e-5)


def test_shard_and_gather_round_trip(four):
    assert all(out["train"]["round_trip"] for out in four.values())


# -- collectives -------------------------------------------------------------------


def test_decode_collectives_equal_the_dry_run_and_a_hand_count(two):
    cfg = ranks.f32_reduced("granite-8b")
    slots = len(ranks.RECORD_POS)
    art = _dry("decode_32k", (1, 2), slots, ranks.RECORD_SEQ)
    act = slots * cfg.d_model * 4  # one (slots, 1, d_model) f32 activation
    hand = {"all-reduce": {"count": 2 * cfg.n_layers + 1,  # attn.o, mlp.out; the embedding
                           "bytes": (2 * cfg.n_layers + 1) * act},
            "all-gather": {"count": 1, "bytes": slots * cfg.vocab_size * 4}}  # the head
    assert art["collectives"] == hand
    assert art["collective_bytes"] == sum(v["bytes"] for v in hand.values())
    assert art["cost"]["collective_bytes"] == 2 * hand["all-reduce"]["bytes"] + slots * \
        cfg.vocab_size * 4
    for out in two.values():
        assert out["serve"]["decode_record"] == hand


def test_train_step_collectives_equal_the_dry_run(four):
    art = _dry("train_4k", (2, 2), ranks.TRAIN_BATCH, ranks.TRAIN_SEQ)
    ops = set(art["collectives"])
    assert ops == {"all-gather", "all-reduce", "reduce-scatter"}
    for out in four.values():
        assert out["train"]["train_record"] == art["collectives"]


def test_reduce_scatter_and_all_to_all_over_gloo(four):
    # on (2, 2) rank r sits at (data r // 2, model r % 2)
    x = {r: ranks.exchange_input(r).numpy() for r in range(4)}
    for r, out in four.items():
        d, m = divmod(r, 2)
        row = [2 * d + j for j in range(2)]  # the ranks of this rank's model axis
        y, g = out["exchanges"]["reduce_scatter"]
        np.testing.assert_array_equal(y, sum(x[q] for q in row)[:, 3 * m:3 * m + 3])
        # backward: the all-gather of the ranks' upstream gradients
        np.testing.assert_array_equal(g, np.concatenate(
            [ranks.exchange_weight(q, (4, 3)).numpy() for q in row], axis=1))
        col = [2 * i + m for i in range(2)]  # the ranks of this rank's data axis
        y, g = out["exchanges"]["all_to_all"]
        np.testing.assert_array_equal(
            y, np.concatenate([x[q][2 * d:2 * d + 2] for q in col], axis=1))
        # backward: row block i comes back from data rank i, at this rank's columns
        np.testing.assert_array_equal(g, np.concatenate(
            [ranks.exchange_weight(q, (2, 12)).numpy()[:, 6 * d:6 * d + 6] for q in col],
            axis=0))
        assert out["exchanges"]["record"] == {
            "reduce-scatter": {"count": 1, "bytes": 4 * 3 * 4},
            "all-gather": {"count": 1, "bytes": 4 * 6 * 4},  # the reduce-scatter's backward
            "all-to-all": {"count": 2, "bytes": 2 * 2 * 12 * 4}}


def test_production_cells_carry_collectives():
    art = dryrun.lower_cell("granite-8b", "decode_32k", False, config_overrides={"n_layers": 2})
    # a layer: attn.o's and mlp.out's sums and, the cache's positions split
    # over model (8 kv heads do not divide 16), the partial softmaxes' max
    # and sum; then the embedding's sum
    assert art["collectives"]["all-reduce"]["count"] == 2 * 4 + 1
    assert art["collective_bytes"] == sum(v["bytes"] for v in art["collectives"].values())
    assert art["cost"]["collective_counts"] == {op: v["count"]
                                                for op, v in art["collectives"].items()}
    ssm = dryrun.lower_cell("mamba2-1.3b", "decode_32k", False, config_overrides={"n_layers": 2})
    # a layer: the projection's and the conv output's all-gathers over model,
    # the FSDP gathers of w_in and w_out over data, ssm.out's all-reduce; the
    # 50280-row vocabulary stays whole over model 16: the table gathered over
    # data for the lookup and for the tied head, the logits' rows over data
    assert ssm["collectives"]["all-reduce"]["count"] == 2
    assert ssm["collectives"]["all-gather"]["count"] == 2 * (2 + 2) + 2 + 1
    assert ssm["collective_bytes"] == sum(v["bytes"] for v in ssm["collectives"].values()) > 0


# -- in-process checks -----------------------------------------------------------


def test_ranked_constrain_checks_the_local_shape():
    plan = sharding.ShardingPlan(virtual_mesh((2, 2)))
    x = torch.zeros(3, 8, 16, device="meta")
    with sharding.use_plan(plan):
        assert sharding.ranked_plan() is plan
        assert sharding.constrain(x, "batch", "seq", None) is x
        with pytest.raises(ValueError, match="keeps it whole"):
            sharding.constrain(x, "batch", None, "heads")
    # sequence parallelism: the residual stream's range of positions a rank
    # holds over model is its local shard; any other dim on model still raises
    with sharding.use_plan(sharding.ShardingPlan(virtual_mesh((2, 2)), {"seq": "model"})):
        local = torch.zeros(3, 4, 16, device="meta")
        assert sharding.constrain(local, "batch", "seq", None) is local
        assert sharding.residual_split(None, 6, 8)
        with pytest.raises(ValueError, match="keeps it whole"):
            sharding.constrain(local, "batch", None, "heads")


def test_virtual_collectives_record_local_shapes_and_grads():
    plan = sharding.ShardingPlan(virtual_mesh((2, 4)))
    x = torch.zeros(3, 8, device="meta", requires_grad=True)
    with sharding.use_plan(plan), collectives.record() as st:
        y = collectives.all_gather(collectives.sum_grad(x, "model"), "data", 0)
        z = collectives.reduce_scatter(y, "model", 1)
        w = collectives.all_to_all(collectives.all_reduce(z, "data"), "data", 0, 1)
        assert tuple(y.shape) == (6, 8) and tuple(z.shape) == (6, 2)
        assert tuple(w.shape) == (3, 4) and w.device.type == "meta"
        w.sum().backward()
    # forward: gather, scatter, all-reduce, all-to-all; backward: all-to-all,
    # all-gather (of the scatter), reduce-scatter (of the gather), the sum_grad
    assert st.counts() == {"all-gather": 2, "all-reduce": 2, "all-to-all": 2,
                           "reduce-scatter": 2}
    assert st.coll_bytes == st.total_bytes + st.per_op["all-reduce"][1]
    with collectives.record() as none:
        assert collectives.all_reduce(x, "model") is x  # no plan: nothing to exchange
    assert none.total_count == 0
