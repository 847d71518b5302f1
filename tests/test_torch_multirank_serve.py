"""Serving across ``torch.distributed`` ranks as ``repro``'s serve CLI runs
under a plan, against ``repro`` on one device, on the CPU: the default
capacity-dispatch MoE, the quantization ladder, the data axis and the paged
engine. ``gloo`` ranks are started by ``torch.multiprocessing`` over a file
rendezvous (``tests/test_torch_multirank_serve_ranks.py`` holds what each
rank runs), every group under a 60 s timeout and the join under its own.
One group of 2 ranks ((1, 2), then (2, 1)) and one of 4 ((2, 2)) serve all
the cases; the same numpy inputs from a seed go to ``repro`` (xla, one
device) in this process. Reduced configs in f32, int8 and int4.

* Quantization: each rank's codes and scales equal ``repro``'s
  ``quantize_lm_params`` of the whole leaf, sliced, bit for bit (int8, int8
  with dynamic activations, int4; (1, 2) and (2, 2)); prefill and decode
  logits within 1e-4 x max|logit| of ``repro``'s one-device model on every
  rung ((1, 2); int8-dynamic also on (2, 2)); the same with each dynamic row
  scale taken over the rank's half of the row fails that limit; a decode
  step's collectives are the float step's plus one MAX all-reduce of the
  rows' f32 amax per row-parallel dynamic dispatch.
* olmoe-1b-7b's MoE layer on ``global``, ``hinted`` and ``sharded``, float
  and int8 experts, on (1, 2) and (2, 2), within 1e-4 of ``repro``'s
  ``moe_apply`` (``sharded`` at ``div["batch"]`` = data), B5 at
  G = E / model; olmoe's engine on its default dispatch.
* The data axis: the slot engine's greedy tokens on (2, 1) (4 slots split,
  3 whole) and (2, 2) equal to ``repro``'s engine; a decode step's logits,
  its ``tag:local_mnk`` keys equal to the one-rank plan's
  (``serve_gemm_div``) and the dry run's, and its collectives equal to the
  dry run's virtual record.
* The paged engine on (1, 2) equal to ``repro``'s paged engine.
* What stays refused across ranks, each with its message.
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

import test_torch_multirank_ranks as mr
import test_torch_multirank_serve_ranks as ranks
from repro.configs import get_reduced as j_get_reduced
from repro.core import quant as jq
from repro.core.gemm import gemm_context as j_gemm_context
from repro.dist.sharding import materialize_tree
from repro.models import build_model as j_build_model
from repro.models import layers as j_layers
from repro.serve import PagedServeConfig as JPagedServeConfig
from repro.serve import PagedServeEngine as JPagedServeEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.core.gemm import gemm_context
from repro_torch.dist import sharding
from repro_torch.launch import dryrun
from repro_torch.launch import serve as t_serve
from repro_torch.launch.mesh import MeshShape, virtual_mesh
from repro_torch.models import build_model
from repro_torch.models.lm import params_from_jax
from repro_torch.serve.engine import serve_gemm_div
from repro_torch.serve.paged_kv import PagedKVCache

pytestmark = pytest.mark.skipif(not torch.distributed.is_gloo_available(),
                                reason="torch.distributed without gloo")

PROMPTS = [np.array(p, np.int32) for p in ([5, 17, 3, 99, 42, 7], [200, 1, 64],
                                           list(range(30, 53)), [9, 8, 7, 6, 5])]
F32 = {"dtype": "float32"}
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2)}


@functools.lru_cache(maxsize=None)
def _repro(arch):
    jcfg = dataclasses.replace(j_get_reduced(arch), **F32)
    jmodel = j_build_model(jcfg)
    jparams = jax.tree.map(np.asarray, materialize_tree(jmodel.param_specs(),
                                                        jax.random.PRNGKey(0)))
    return jmodel, jparams


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(1, 256, shape)


def _group(tmp_path_factory, program, world):
    workdir = tmp_path_factory.mktemp(program.__name__)
    inputs = {"granite-8b": _repro("granite-8b")[1], "olmoe-1b-7b": _repro("olmoe-1b-7b")[1],
              "tokens": _tokens(ranks.TOKENS_SHAPE, 3),
              "decode_tokens": _tokens((len(ranks.RECORD_POS), 1), 5), "prompts": PROMPTS,
              "rows4": _tokens(ranks.ROWS4_SHAPE, 7),
              "moe": ranks.f32_olmoe_moe_inputs()}
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    return mr.run_ranks(program, world, workdir, timeout=240)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _group(tmp_path_factory, ranks.program_two, 2)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _group(tmp_path_factory, ranks.program_four, 4)


def _group_of(mesh, two, four):
    """(mesh shape, each rank's coordinates and output) of a mesh's run."""
    shape = MESHES[mesh]
    group = four if shape == (2, 2) else two
    return shape, [(divmod(r, shape[1]), out) for r, out in group.items()]


# -- quantization ----------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _repro_quantized(rung):
    jmodel, jparams = _repro("granite-8b")
    bits, act_bits = ranks.RUNGS[rung]
    qparams, n, _ = jmodel.quantize_weights(jax.tree.map(jnp.asarray, jparams), bits=bits,
                                            act_bits=act_bits)
    return qparams, n


def _slice_like_rank(full, shape, coords, specs):
    """``repro``'s whole quantized leaves, cut as the rank at ``coords`` of a
    ``shape`` mesh holds them."""
    plan = sharding.ShardingPlan(virtual_mesh(shape, coords={"data": coords[0],
                                                             "model": coords[1]}))
    return sharding.shard_tree(full, plan, plan.mesh.coords, specs)


@pytest.mark.parametrize("rung", list(ranks.RUNGS))
@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_quantized_shards_equal_repros_quantize_then_shard(two, four, mesh, rung):
    qparams, n = _repro_quantized(rung)
    full = params_from_jax(jax.tree.map(np.asarray, qparams), device="cpu")
    model = build_model(mr.f32_reduced("granite-8b"))
    shape, per_rank = _group_of(mesh, two, four)
    for coords, out in per_rank:
        got = out["quant"][rung]
        assert got["n"] == n
        want = ranks._quant_parts(_slice_like_rank(full, shape, coords, model.param_specs()))
        assert sorted(got["parts"]) == sorted(want) and len(want) == 8
        for path, (values, scales) in want.items():
            assert got["parts"][path][0].tobytes() == values.tobytes(), path
            assert got["parts"][path][1].tobytes() == scales.tobytes(), path
    # every rank holds a different shard of the row-parallel attn.o (K on model)
    wo = [out["quant"][rung]["parts"]["layers/attn/wo"][0] for _, out in per_rank]
    assert not np.array_equal(wo[0], wo[1])


@functools.lru_cache(maxsize=None)
def _repro_chain(rung, shape=ranks.TOKENS_SHAPE, seed=3):
    """``repro``'s prefill and greedy decode chain on one device (``rung``
    None: the float weights)."""
    jmodel, jparams = _repro("granite-8b")
    qparams = jax.tree.map(jnp.asarray, jparams) if rung is None else _repro_quantized(rung)[0]
    tokens = jnp.asarray(_tokens(shape, seed))
    with j_gemm_context(backend="xla"):
        logits, cache = jmodel.prefill(qparams, tokens, max_seq=ranks.CACHE_SEQ)
        chain = [np.asarray(logits)]
        pos = jnp.full((tokens.shape[0],), tokens.shape[1])
        for _ in range(ranks.DECODE_STEPS):
            nxt = jnp.argmax(logits[:, -1], axis=-1)[:, None]
            logits, cache = jmodel.decode_step(qparams, cache, nxt, pos)
            chain.append(np.asarray(logits))
            pos = pos + 1
    return chain


def _chain_err(chain, want):
    assert len(chain) == len(want)
    return max(np.abs(got - ref).max() / np.abs(ref).max() for got, ref in zip(chain, want))


@pytest.mark.parametrize("mesh,rung", [("1x2", "int8"), ("1x2", "int8-dynamic"),
                                       ("1x2", "int4"), ("2x2", "int8-dynamic")])
def test_quantized_logits_match_repros_one_device_model(two, four, mesh, rung):
    want = _repro_chain(rung)
    _, per_rank = _group_of(mesh, two, four)
    for _, out in per_rank:
        assert _chain_err(out["quant"][rung]["chain"], want) <= 1e-4


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_a_local_dynamic_row_amax_fails_the_parity(two, four, mesh):
    want = _repro_chain("int8-dynamic")
    _, per_rank = _group_of(mesh, two, four)
    for _, out in per_rank:
        assert _chain_err(out["quant"]["int8-dynamic"]["chain_local_amax"], want) > 1e-3


def test_quantized_decode_collectives_add_one_max_all_reduce_per_dynamic_dispatch(two):
    cfg = mr.f32_reduced("granite-8b")
    rows = len(ranks.RECORD_POS)
    for out in two.values():
        q = out["quant"]
        float_rec = q["float_record"]
        assert q["int8"]["record"] == float_rec and q["int4"]["record"] == float_rec
        want = json_copy(float_rec)
        want["all-reduce"]["count"] += 2 * cfg.n_layers  # attn.o and mlp.out
        want["all-reduce"]["bytes"] += 2 * cfg.n_layers * rows * 4  # (rows, 1) f32
        assert q["int8-dynamic"]["record"] == want


def json_copy(d):
    return {k: dict(v) for k, v in d.items()}


# -- the MoE layer ------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _repro_moe(impl, kind, data):
    jcfg = dataclasses.replace(j_get_reduced("olmoe-1b-7b"), moe_impl=impl,
                               capacity_factor=ranks.MOE_CAPACITY, **F32)
    p_np, x = ranks.f32_olmoe_moe_inputs()
    p = {k: jnp.asarray(v) for k, v in p_np.items()}
    if kind == "int8":
        p = jq.quantize_lm_params(p)[0]
    div = {"batch": data} if impl == "sharded" else {}
    with j_gemm_context(backend="xla"):
        y, aux = j_layers.moe_apply(p, jnp.asarray(x), jcfg, div=div)
    return np.asarray(y), float(aux)


@pytest.mark.parametrize("kind", ["float", "int8"])
@pytest.mark.parametrize("impl", list(ranks.MOE_IMPLS))
@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_moe_variants_across_ranks_match_repros_moe_apply(two, four, mesh, impl, kind):
    shape, per_rank = _group_of(mesh, two, four)
    data = shape[0]
    # only sharded's groups depend on the data axis
    want, want_aux = _repro_moe(impl, kind, data if impl == "sharded" else 1)
    rows = want.shape[0] // data
    for (d, _), out in per_rank:
        got = out["moe"][impl, kind]
        ref = want[d * rows:(d + 1) * rows]
        np.testing.assert_allclose(got["y"], ref, rtol=0, atol=1e-4 * np.abs(want).max())
        if data == 1:
            np.testing.assert_allclose(got["aux"], want_aux, rtol=1e-5)
        assert got["groups"] == [8 // shape[1]]  # B5 at G = E / model


@functools.lru_cache(maxsize=None)
def _repro_engine(arch, slots):
    jmodel, jparams = _repro(arch)
    jeng = JServeEngine(jmodel, jax.tree.map(jnp.asarray, jparams),
                        JServeConfig(n_slots=slots, max_seq=ranks.ENGINE_SEQ, eos=-1))
    with j_gemm_context(backend="xla"):
        for p in PROMPTS:
            jeng.submit(p, max_new_tokens=ranks.ENGINE_NEW)
        return {r.uid: r.out_tokens for r in jeng.run()}


@pytest.mark.parametrize("mesh", ["1x2", "2x1", "2x2"])
def test_olmoe_engine_on_its_default_dispatch_matches_repros(two, four, mesh):
    want = _repro_engine("olmoe-1b-7b", ranks.ENGINE_SLOTS)
    _, per_rank = _group_of(mesh, two, four)
    for _, out in per_rank:
        got = out["olmoe_engine"] if mesh == "1x2" else out["data"]["olmoe_engine"]
        assert got["tokens"] == want


# -- the data axis ---------------------------------------------------------------------


@pytest.mark.parametrize("mesh", ["2x1", "2x2"])
def test_engine_tokens_on_the_data_axis_match_repros_engine(two, four, mesh):
    shape, per_rank = _group_of(mesh, two, four)
    want = _repro_engine("granite-8b", ranks.ENGINE_SLOTS)
    assert len(want) == len(PROMPTS)
    half = ranks.ENGINE_SLOTS // 2
    for (d, _), out in per_rank:
        eng = out["data"]["engine"]
        assert eng["tokens"] == want
        assert eng["own"] == (d * half, (d + 1) * half) and eng["cache_rows"] == half
        if "engine_whole" in out["data"]:  # 3 slots: every rank runs every row
            whole = out["data"]["engine_whole"]
            assert whole["tokens"] == _repro_engine("granite-8b", 3)
            assert whole["own"] is None and whole["cache_rows"] == 3


@functools.lru_cache(maxsize=None)
def _repro_decode_logits():
    jmodel, jparams = _repro("granite-8b")
    cache = jmodel.init_cache(len(ranks.RECORD_POS), ranks.RECORD_SEQ)
    with j_gemm_context(backend="xla"):
        logits, _ = jmodel.decode_step(jax.tree.map(jnp.asarray, jparams), cache,
                                       jnp.asarray(_tokens((len(ranks.RECORD_POS), 1), 5)),
                                       jnp.asarray(ranks.RECORD_POS))
    return np.asarray(logits)


def _one_rank_plan_keys(shape):
    """The keys of the same decode step in one process under a device-free
    plan of ``shape``: whole tensors, ``serve_gemm_div``'s divisors."""
    model = build_model(mr.f32_reduced("granite-8b"))
    params = params_from_jax(_repro("granite-8b")[1], device="cpu")
    tokens = torch.as_tensor(_tokens((len(ranks.RECORD_POS), 1), 5)).long()
    with sharding.use_plan(sharding.ShardingPlan(MeshShape(shape, ("data", "model")))), \
            torch.no_grad():
        div = serve_gemm_div(model, len(ranks.RECORD_POS))
        assert div == {"batch": shape[0], "model": shape[1]}
        cache = model.init_cache(len(ranks.RECORD_POS), ranks.RECORD_SEQ, device="cpu")
        with gemm_context(device="cpu") as ctx:
            model.decode_step(params, cache, tokens, torch.as_tensor(ranks.RECORD_POS), div=div)
    return mr.dispatch_keys(ctx.log)


def _dry(shape, arch="granite-8b"):
    """The dry run of the same cell under the rules the ranks run (the
    default ones)."""
    return dryrun.lower_cell(
        arch, "decode_32k", False, mesh_shape=shape,
        extra_rules=dict(sharding.DEFAULT_RULES),
        config_overrides=dataclasses.asdict(mr.f32_reduced(arch)),
        shape_overrides={"global_batch": len(ranks.RECORD_POS), "seq_len": ranks.RECORD_SEQ})


@pytest.mark.parametrize("mesh", ["2x1", "2x2"])
def test_data_axis_decode_matches_the_one_rank_plan_and_the_dry_run(two, four, mesh):
    shape, per_rank = _group_of(mesh, two, four)
    want = _repro_decode_logits()
    keys = _one_rank_plan_keys(shape)
    art = _dry(shape)
    assert sorted(art["dispatch"]) == keys
    assert all(k.split(":")[1].startswith(f"({len(ranks.RECORD_POS) // shape[0]},")
               for k in keys)  # every GEMM at the rank's rows
    gathers = art["collectives"]["all-gather"]
    chain = _repro_chain(None, ranks.ROWS4_SHAPE, 7)
    for _, out in per_rank:
        data = out["data"]
        assert _chain_err(data["chain"], chain) <= 1e-4  # the prefill's cache of 2 rows a rank
        np.testing.assert_allclose(data["decode_logits"], want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
        assert data["decode_keys"] == keys
        assert data["record"] == art["collectives"]
    # the logits' gather over data: (rows, 1, V) f32 per rank after the vocab's
    cfg = mr.f32_reduced("granite-8b")
    assert gathers["bytes"] >= len(ranks.RECORD_POS) * cfg.vocab_size * 4
    # olmoe: its MoE layers' counts exchange over data, as the dry run traces it
    olmoe = _dry(shape, "olmoe-1b-7b")["collectives"]
    assert all(out["data"]["olmoe_record"] == olmoe for _, out in per_rank)
    # against the per-data-row shard_map body: one more all-gather a layer,
    # the (data, k, E) int32 counts
    moe = mr.f32_reduced("olmoe-1b-7b")
    body = dryrun.lower_cell(
        "olmoe-1b-7b", "decode_32k", False, mesh_shape=shape,
        config_overrides=dict(dataclasses.asdict(moe), moe_impl="shard_map"),
        shape_overrides={"global_batch": len(ranks.RECORD_POS),
                         "seq_len": ranks.RECORD_SEQ})["collectives"]["all-gather"]
    assert olmoe["all-gather"] == {
        "count": body["count"] + moe.n_layers,
        "bytes": body["bytes"] + moe.n_layers * shape[0] * moe.top_k * moe.n_experts * 4}


# -- the paged engine --------------------------------------------------------------------


def test_paged_engine_on_the_model_axis_matches_repros(two):
    jmodel, jparams = _repro("granite-8b")
    jeng = JPagedServeEngine(jmodel, jax.tree.map(jnp.asarray, jparams),
                             JPagedServeConfig(**ranks.PAGED), backend="xla")
    for p in PROMPTS:
        jeng.submit(p, max_new_tokens=ranks.ENGINE_NEW)
    want = {r.uid: r.out_tokens for r in jeng.run()}
    assert len(want) == len(PROMPTS)
    cfg = mr.f32_reduced("granite-8b")
    for out in two.values():
        assert out["paged"]["tokens"] == want
        assert out["paged"]["metrics"] == jeng.metrics()
        assert out["paged"]["kv_heads"] == cfg.n_kv_heads // 2  # this rank's kv heads


# -- what stays refused, and what builds ------------------------------------------------------------------


def test_what_stays_refused_across_ranks_says_so(monkeypatch):
    with sharding.use_plan(sharding.ShardingPlan(virtual_mesh((2, 1)))):
        with pytest.raises(NotImplementedError, match="splits the model axis only"):
            PagedKVCache(build_model(mr.f32_reduced("granite-8b")), page_size=8, n_pages=4,
                         device="cpu")
        # the SSM, hybrid and VLM families build across ranks: this rank's shards
        for arch in ("mamba2-1.3b", "zamba2-1.2b", "llava-next-34b"):
            model = build_model(mr.f32_reduced(arch))
            params = model.init_params("cpu")
            plan = sharding.current_plan()
            for path, spec in sharding.spec_items(model.param_specs()):
                leaf = params
                for key in path.split("/"):
                    leaf = leaf[key]
                assert tuple(leaf.shape) == plan.local_shape(spec), (arch, path)
    monkeypatch.setenv("WORLD_SIZE", "2")
    base = ["--arch", "granite-8b", "--device", "cpu"]
    for argv, match in ((["--mesh-model", "2", "--workers", "2"], "--workers runs on one rank"),
                        (["--mesh-model", "1", "--paged"], "would split the page pool"),
                        ([], "need --mesh-model")):
        with pytest.raises(SystemExit, match=match):
            t_serve.main(base + argv)


def test_virtual_max_all_reduce_records_as_an_all_reduce():
    from repro_torch.core.quant import quantize_activations
    from repro_torch.dist import collectives

    x = torch.zeros(4, 1, 32, device="meta")
    with sharding.use_plan(sharding.ShardingPlan(virtual_mesh((1, 2)))), \
            collectives.record() as st:
        quantize_activations(x, axis="model")
        assert collectives.all_reduce_max(torch.zeros(3), ()) is not None
    assert st.summary() == {"all-reduce": {"count": 1, "bytes": 4 * 1 * 4}}


@pytest.mark.parametrize("argv", [
    ["--arch", "olmoe-1b-7b", "--quantize", "int8", "--mesh-model", "2"],
    ["--arch", "granite-8b", "--quantize", "int4", "--mesh-model", "1"],
    ["--arch", "granite-8b", "--quantize", "int8-dynamic", "--mesh-model", "2", "--paged"],
], ids=["olmoe-int8-1x2", "granite-int4-2x1", "granite-int8-dynamic-paged-1x2"])
def test_serve_cli_on_two_ranks_serves_the_one_rank_tokens(argv, tmp_path):
    """The serve CLI under ``torch.distributed.run`` on two CPU ranks, as
    ``repro``'s serve CLI runs under a plan: olmoe on its default MoE
    dispatch with int8 experts, granite int4 on the data axis, granite
    int8-dynamic paged on the model axis; the same greedy tokens as the
    CLI in one process, and the summary names the rung and the mesh."""
    import json
    import subprocess
    import sys

    base = ["--preset", "reduced", "--dtype", "float32", "--device", "cpu", "--requests", "4",
            "--max-seq", "48", "--max-new-tokens", "4"]
    path = tmp_path / "ranks.json"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "repro_torch.launch.serve", *base, *argv, "--summary-json", str(path)],
        env=env, cwd=root, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    ranked = json.loads(path.read_text())
    one = tmp_path / "one.json"
    mesh = argv.index("--mesh-model")
    assert t_serve.main(base + argv[:mesh] + argv[mesh + 2:] + ["--summary-json", str(one)]) == 0
    single = json.loads(one.read_text())
    assert ranked["completed"] == 4 and ranked["quantize"] == argv[3]
    model_n = int(argv[mesh + 1])
    assert ranked["mesh"]["shape"] == {"data": 2 // model_n, "model": model_n}
    assert ranked["workers"][0]["out_tokens"] == single["workers"][0]["out_tokens"]


def test_an_int4_shard_of_k_must_hold_whole_nibble_pairs():
    from repro_torch.core.quant import quantize_lm_params, quantize_weight

    spec = sharding.ArraySpec((6, 4), "float32", ("heads", "embed"))  # K = 6 over model 2
    plan = sharding.ShardingPlan(virtual_mesh((1, 2)))
    with sharding.use_plan(plan):
        with pytest.raises(ValueError, match="whole nibble pairs"):
            quantize_lm_params({"wo": torch.ones(3, 4)}, bits=4, specs={"wo": spec}, plan=plan)
        with pytest.raises(ValueError, match="whole nibble pairs"):
            sharding.shard_leaf(quantize_weight(torch.ones(6, 4), bits=4), plan, spec,
                                plan.mesh.coords)
    # an even local K splits with its packed rows
    even = sharding.ArraySpec((8, 4), "float32", ("heads", "embed"))
    shard = sharding.shard_leaf(quantize_weight(torch.ones(8, 4), bits=4), plan, even,
                                plan.mesh.coords)
    assert shard.k == 4 and tuple(shard.values.shape) == (2, 4)
