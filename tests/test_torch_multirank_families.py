"""The SSM, hybrid, VLM and encoder-decoder families served across
``torch.distributed`` ranks, against ``repro`` on one device, on the CPU:
mamba2-1.3b, zamba2-1.2b, llava-next-34b (with patch embeddings) and
whisper-large-v3 (with frames), reduced in f32. ``gloo`` ranks are started
by ``torch.multiprocessing`` over a file rendezvous
(``tests/test_torch_multirank_families_ranks.py`` holds what each rank
runs), every group under a 60 s timeout and the join under its own: one
group of 2 ranks ((1, 2), then (2, 1)) and one of 4 ((2, 2), then (1, 4)). The same
numpy inputs from a seed go to ``repro`` (xla, one device) in this process.

* Prefill and decode logits within 1e-4 x max|logit| of ``repro``'s: all
  four families on (1, 2), mamba2 also on (2, 1) and (2, 2), and on (1, 4)
  llava and whisper with 6 query heads and mamba2 with 2 SSM heads (heads
  that do not divide the model axis).
* The slot engine's greedy tokens for mamba2 and zamba2 equal to
  ``repro``'s ``ServeEngine`` (more requests than slots: reused slots).
* Each rank's ``ssm`` cache shards: the local shapes of ``repro``'s
  ``cache_specs`` under the plan, and ``repro``'s full prefill cache
  sliced, within 1e-4.
* Each rank's dispatch keys (``ssm.in``/``ssm.out`` among them) equal to
  the one-rank plan's (``serve_gemm_div``).
* A decode step's collectives equal to the dry run's virtual record of the
  same cell, and every production cell of the four families records its
  collectives.
"""

import dataclasses
import functools
import math
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_multirank_families_ranks as ranks
import test_torch_multirank_ranks as mr
from repro.configs import get_reduced as j_get_reduced
from repro.core.gemm import gemm_context as j_gemm_context
from repro.dist import sharding as j_sharding
from repro.dist.sharding import materialize_tree
from repro.models import build_model as j_build_model
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.core.gemm import gemm_context
from repro_torch.dist import sharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import applicable_shapes, build_model
from repro_torch.models.lm import params_from_jax
from repro_torch.serve.engine import serve_gemm_div

pytestmark = pytest.mark.skipif(not torch.distributed.is_gloo_available(),
                                reason="torch.distributed without gloo")

PROMPTS = [np.array(p, np.int32) for p in (list(range(3, 14)), [200, 1], list(range(100, 119)),
                                           [7, 9, 11, 5, 3])]
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2), "1x4": (1, 4)}
SERVED = ([("1x2", arch) for arch in ranks.FAMILIES]
          + [("2x1", "mamba2-1.3b"), ("2x2", "mamba2-1.3b")]
          + [("1x4", case) for case in ranks.UNEVEN])


@functools.lru_cache(maxsize=None)
def _repro(arch):
    """``repro``'s model and parameters (numpy) of a family or an ``UNEVEN`` case."""
    over = ranks.UNEVEN.get(arch, (None, {}))[1]
    jmodel = j_build_model(dataclasses.replace(j_get_reduced(ranks.arch_of(arch)),
                                               dtype="float32", **over))
    jparams = jax.tree.map(np.asarray, materialize_tree(jmodel.param_specs(),
                                                        jax.random.PRNGKey(0)))
    return jmodel, jparams


def _group(tmp_path_factory, program, world):
    workdir = tmp_path_factory.mktemp(program.__name__)
    inputs = {arch: dict(zip(("tokens", "extra"), ranks.family_inputs(arch)),
                         params=_repro(arch)[1]) for arch in ranks.FAMILIES + tuple(ranks.UNEVEN)}
    inputs["prompts"] = PROMPTS
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    return mr.run_ranks(program, world, workdir, timeout=240)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _group(tmp_path_factory, ranks.program_two, 2)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _group(tmp_path_factory, ranks.program_four, 4)


def _runs(mesh, arch, two, four):
    """(mesh shape, each rank's (data, model) coordinates and run)."""
    shape = MESHES[mesh]
    group = four if math.prod(shape) == 4 else two
    return shape, [(divmod(r, shape[1]), out[mesh][arch]) for r, out in group.items()]


def _prefill(model, params, lib, arch):
    tokens, extra = ranks.family_inputs(arch)
    tokens = lib(tokens)
    extra = None if extra is None else lib(extra)
    return ranks.prefill(model, params, tokens, extra)


@functools.lru_cache(maxsize=None)
def _repro_chain(arch):
    """``repro``'s prefill logits and greedy decode chain on one device, and
    its prefill cache (numpy)."""
    jmodel, jparams = _repro(arch)
    params = jax.tree.map(jnp.asarray, jparams)
    with j_gemm_context(backend="xla"):
        logits, cache = _prefill(jmodel, params, jnp.asarray, arch)
        prefill_cache = jax.tree.map(np.asarray, cache)
        chain = [np.asarray(logits)]
        pos = jnp.full((ranks.ROWS,), ranks.PROMPT)
        for _ in range(ranks.DECODE_STEPS):
            nxt = jnp.argmax(logits[:, -1], axis=-1)[:, None]
            logits, cache = jmodel.decode_step(params, cache, nxt, pos)
            chain.append(np.asarray(logits))
            pos = pos + 1
    return chain, prefill_cache


@pytest.mark.parametrize("mesh,arch", SERVED)
def test_prefill_and_decode_logits_match_repros_one_device_model(two, four, mesh, arch):
    want, _ = _repro_chain(arch)
    _, runs = _runs(mesh, arch, two, four)
    for _, run in runs:
        assert len(run["chain"]) == len(want) == ranks.DECODE_STEPS + 1
        for got, ref in zip(run["chain"], want):
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("arch", ranks.ENGINE_FAMILIES)
def test_engine_greedy_tokens_match_repros_engine(two, arch):
    jmodel, jparams = _repro(arch)
    jeng = JServeEngine(jmodel, jax.tree.map(jnp.asarray, jparams),
                        JServeConfig(n_slots=ranks.ENGINE_SLOTS, max_seq=ranks.ENGINE_SEQ, eos=-1))
    with j_gemm_context(backend="xla"):
        for p in PROMPTS:
            jeng.submit(p, max_new_tokens=ranks.ENGINE_NEW)
        want = {r.uid: r.out_tokens for r in jeng.run()}
    assert len(want) == len(PROMPTS) > ranks.ENGINE_SLOTS
    specs = jmodel.cache_specs(ranks.ENGINE_SLOTS, ranks.ENGINE_SEQ)["ssm"]
    for r, out in two.items():
        assert out["engine"][arch]["tokens"] == want
        assert out["engine"][arch]["ssm_shapes"] == {
            key: _repro_local(spec, (1, 2))[0] for key, spec in specs.items()}


def _repro_local(jspec, shape, coords=(0, 0)):
    """(local shape, the rank's slices) of a ``repro`` cache spec under
    ``repro``'s own plan on a ``shape`` mesh, for the rank at ``coords``."""
    plan = j_sharding.ShardingPlan(MeshShape(shape, ("data", "model")))
    at = dict(zip(("data", "model"), coords))
    local, slices = [], []
    for dim, part in zip(jspec.shape, plan.spec_for(jspec)):
        axes = () if part is None else ((part,) if isinstance(part, str) else tuple(part))
        n = math.prod(shape[("data", "model").index(a)] for a in axes)
        index = 0
        for a in axes:
            index = index * shape[("data", "model").index(a)] + at[a]
        local.append(dim // n)
        slices.append(slice(index * (dim // n), (index + 1) * (dim // n)))
    return tuple(local), tuple(slices)


@pytest.mark.parametrize("mesh,arch", [("1x2", "mamba2-1.3b"), ("2x1", "mamba2-1.3b"),
                                       ("2x2", "mamba2-1.3b"), ("1x2", "zamba2-1.2b")])
def test_ssm_cache_shards_are_repros_cache_sliced(two, four, mesh, arch):
    _, want = _repro_chain(arch)
    jmodel = _repro(arch)[0]
    specs = jmodel.cache_specs(ranks.ROWS, ranks.CACHE_SEQ)["ssm"]
    shape, runs = _runs(mesh, arch, two, four)
    seen = set()
    for coords, run in runs:
        assert sorted(run["ssm"]) == ["conv", "h"]
        for key, got in run["ssm"].items():
            local, slices = _repro_local(specs[key], shape, coords)
            assert got.shape == local, key
            full = want["ssm"][key]
            np.testing.assert_allclose(got, full[slices], rtol=0,
                                       atol=1e-4 * np.abs(full).max())
            seen.add((key, tuple((s.start, s.stop) for s in slices)))
    # every rank holds its own part: h on its heads, conv on its channels
    assert len(seen) == 2 * len(runs)


def _one_rank_plan_keys(arch):
    """The keys of the same prefill and decode chain in one process under a
    device-free (1, 2) plan: whole tensors, ``serve_gemm_div``'s divisors."""
    model = build_model(mr.f32_reduced(arch))
    params = params_from_jax(_repro(arch)[1], device="cpu")
    with sharding.use_plan(sharding.ShardingPlan(MeshShape((1, 2), ("data", "model")))), \
            torch.no_grad():
        div = serve_gemm_div(model, ranks.ROWS)
        assert div == {"batch": 1, "model": 2}
        with gemm_context(device="cpu") as ctx:
            tokens, extra = ranks.family_inputs(arch)
            tokens = torch.as_tensor(tokens).long()
            extra = None if extra is None else torch.from_numpy(extra)
            family = model.cfg.family
            if family == "encdec":
                logits, cache = model.prefill(params, extra, tokens, max_seq=ranks.CACHE_SEQ,
                                              div=div)
            else:
                kw = {"patch_embeds": extra} if family == "vlm" else {}
                logits, cache = model.prefill(params, tokens, max_seq=ranks.CACHE_SEQ, div=div,
                                              **kw)
        prefill = mr.dispatch_keys(ctx.log)
        with gemm_context(device="cpu") as ctx:
            model.decode_step(params, cache, logits[:, -1].argmax(-1)[:, None],
                              torch.full((ranks.ROWS,), ranks.PROMPT), div=div)
    return prefill, mr.dispatch_keys(ctx.log)


@pytest.mark.parametrize("arch", ranks.FAMILIES)
def test_dispatch_keys_equal_the_one_rank_plan(two, arch):
    prefill, decode = _one_rank_plan_keys(arch)
    _, runs = _runs("1x2", arch, two, None)
    for _, run in runs:
        assert run["prefill_keys"] == prefill
        assert run["decode_keys"] == decode
    if arch in ranks.ENGINE_FAMILIES:
        cfg = mr.f32_reduced(arch)
        n_in = 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads
        # ssm.in at half its fused columns, ssm.out at half its rows
        assert f"ssm.in:({ranks.ROWS}, {n_in // 2}, {cfg.d_model})" in decode
        assert f"ssm.out:({ranks.ROWS}, {cfg.d_model}, {cfg.d_inner // 2})" in decode


@pytest.mark.parametrize("case", list(ranks.UNEVEN))
def test_uneven_heads_split_inside_a_head_on_one_by_four(four, case):
    """The ``UNEVEN`` cases run the path they are there for: a quarter of
    the query columns a rank (1.5 heads), or whole ``w_in`` and a quarter of
    ``w_out``'s rows (half an SSM head)."""
    cfg = ranks.config_of(case)
    _, runs = _runs("1x4", case, None, four)
    if cfg.family == "ssm":
        assert cfg.ssm_heads % 4 and cfg.d_inner % 4 == 0
        n_in = 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads
        want = {f"ssm.in:({ranks.ROWS}, {n_in}, {cfg.d_model})",
                f"ssm.out:({ranks.ROWS}, {cfg.d_model}, {cfg.d_inner // 4})"}
    else:
        assert cfg.n_heads % 4 and cfg.n_heads * cfg.d_head % 4 == 0
        want = {f"attn.q:({ranks.ROWS}, {cfg.n_heads * cfg.d_head // 4}, {cfg.d_model})"}
    for _, run in runs:
        assert want <= set(run["decode_keys"])


def _dry(arch, shape):
    """The dry run of the same cell under the rules the ranks run (the
    default ones)."""
    return dryrun.lower_cell(
        ranks.arch_of(arch), "decode_32k", False, mesh_shape=shape,
        extra_rules=dict(sharding.DEFAULT_RULES),
        config_overrides=dataclasses.asdict(ranks.config_of(arch)),
        shape_overrides={"global_batch": len(ranks.RECORD_POS), "seq_len": ranks.RECORD_SEQ})


@pytest.mark.parametrize("mesh,arch", SERVED)
def test_decode_collectives_equal_the_dry_runs(two, four, mesh, arch):
    shape, runs = _runs(mesh, arch, two, four)
    want = _dry(arch, shape)["collectives"]
    assert want and all(v["count"] for v in want.values())
    for _, run in runs:
        assert run["record"] == want
    if arch == "mamba2-1.3b" and shape == (1, 2):
        # a layer: the whole projection's and the whole conv output's
        # all-gathers, ssm.out's f32 all-reduce; then the embedding's
        # all-reduce and the logits' gather (f32 payloads of the slots' rows)
        cfg = mr.f32_reduced(arch)
        rows, layers = len(ranks.RECORD_POS) * 4, cfg.n_layers
        n_in = 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads
        conv = cfg.d_inner + 2 * cfg.ssm_state
        assert want == {
            "all-gather": {"count": 2 * layers + 1,
                           "bytes": rows * (layers * (n_in + conv) + cfg.vocab_size)},
            "all-reduce": {"count": layers + 1, "bytes": rows * (layers + 1) * cfg.d_model}}


@pytest.mark.parametrize("arch,shape", [
    (arch, s.name) for arch in ranks.FAMILIES for s in applicable_shapes(get_config(arch))])
def test_every_production_cell_of_the_families_records_its_collectives(arch, shape):
    # zamba2's shared block first runs at layer 6 (every attn_every-th)
    over = {"n_layers": 6 if arch == "zamba2-1.2b" else 2}
    if arch == "whisper-large-v3":
        over["n_enc_layers"] = 2
    art = dryrun.lower_cell(arch, shape, False, config_overrides=over)
    assert art["status"] == "ok" and "collectives_note" not in art
    coll = art["collectives"]
    assert coll and all(v["count"] > 0 and v["bytes"] > 0 for v in coll.values())
    assert art["collective_bytes"] == sum(v["bytes"] for v in coll.values())
    assert art["cost"]["collective_counts"] == {op: v["count"] for op, v in coll.items()}
