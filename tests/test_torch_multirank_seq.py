"""``repro``'s production sharding rules across ``torch.distributed`` ranks,
against ``repro`` on one device, on the CPU: sequence-parallel training
(``seq`` on ``model``, the ``train_4k`` rule), decode caches whose
positions split over the ``kv_seq`` axes (the decode rules) and
Adafactor's factored moments, reduced configs in f32. ``gloo`` ranks are
started by ``torch.multiprocessing`` over a file rendezvous
(``tests/test_torch_multirank_seq_ranks.py`` holds what each rank runs):
one group of 2 ranks ((1, 2), then (2, 1)) and one of 4 ((2, 2), then
(1, 4)). The same numpy inputs from a seed go to ``repro`` (xla, one
device) in this process.

* A train step on (1, 2) and (2, 2) under ``seq = "model"`` for granite,
  olmoe, mamba2 and whisper (its encoder and decoder), and on (1, 4) with
  whole kv weights whose heads the ranks read in part: the loss within
  1e-4 of ``repro``'s and every gradient leaf, gathered whole, within
  1e-4 x max|g| of ``jax.grad`` (the norms', which cover each rank's
  positions, among them).
* Decode under ``kv_seq``: granite on (1, 4), whose 2 kv heads do not
  divide the model axis, so its rule splits the cache's positions over
  ``model`` (model-dtype and int8 caches), and zamba2 with one row on
  (2, 1) under ``long_500k``'s rule (the positions over ``data``): prefill
  and decode logits within 1e-4 x max|logit|, each rank's cache leaves at
  the local shapes of ``repro``'s ``cache_specs`` under its own plan and
  equal to ``repro``'s prefill cache sliced, and the slot engine's greedy
  tokens equal to ``repro``'s ``ServeEngine`` (more requests than slots).
* Adafactor: three steps on (1, 2) and (2, 1), the parameters and the
  gathered ``vr``/``vc`` within 1e-5 relative of ``repro``'s on one device.
* A step's collectives equal to the dry run's virtual record of the same
  cell under the same rules.
"""

import dataclasses
import functools
import math
import os
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_multirank_ranks as mr
import test_torch_multirank_seq_ranks as ranks
from repro.configs import get_reduced as j_get_reduced
from repro.core.gemm import gemm_context as j_gemm_context
from repro.dist import sharding as j_sharding
from repro.models import build_model as j_build_model
from repro.optim import make_optimizer as j_make_optimizer
from repro.optim import warmup_cosine as j_warmup_cosine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train import init_train_state as j_init_train_state
from repro.train import make_train_step as j_make_train_step
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshShape
from repro_torch.utils.trees import tree_items

pytestmark = pytest.mark.skipif(not torch.distributed.is_gloo_available(),
                                reason="torch.distributed without gloo")

ARCHS = ("granite-8b", "olmoe-1b-7b", "mamba2-1.3b", "zamba2-1.2b", "whisper-large-v3")
PROMPTS = [np.array(p, np.int32) for p in (list(range(3, 14)), [200, 1], list(range(100, 119)),
                                           [7, 9, 11, 5, 3])]
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2), "1x4": (1, 4)}


def _jcfg(case):
    arch, over = ranks.arch_and_overrides(case)
    return dataclasses.replace(j_get_reduced(arch), dtype="float32", **over)


@functools.lru_cache(maxsize=None)
def _repro(case):
    """``repro``'s model of a case and its parameter tree, drawn with numpy
    from a seed as ``repro`` initialises it (zeros, ones, or a normal over
    the square root of the fan-in); one draw per arch (a case that changes
    the parameters' shapes, ``WHOLE_KV``, draws its own)."""
    arch = case if case in ranks.WHOLE_KV else ranks.arch_and_overrides(case)[0]
    rng = np.random.default_rng(0)

    def leaf(spec):
        if spec.init in ("zeros", "ones"):
            return np.full(spec.shape, spec.init == "ones", np.float32)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        return (rng.standard_normal(spec.shape) / math.sqrt(fan_in)).astype(np.float32)

    specs = j_build_model(_jcfg(arch)).param_specs()
    jparams = jax.tree.map(leaf, specs, is_leaf=lambda t: isinstance(t, j_sharding.ArraySpec))
    return j_build_model(_jcfg(case)), jparams


def _start(workdir, program, world):
    """Start ``world`` ranks of ``program`` over a file rendezvous in
    ``workdir`` without waiting for them."""
    import torch.multiprocessing as tmp

    return tmp.start_processes(mr._entry, args=(program, world, str(workdir)), nprocs=world,
                               join=False, start_method="spawn")


def _join(ctx, workdir, world, deadline):
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} ranks ran past their deadline")
    out = {}
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            out[r] = pickle.load(f)
    return out


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Both groups of ranks, started together; ``repro``'s references are
    computed in this process while they run."""
    inputs = {arch: _repro(arch)[1] for arch in ARCHS + tuple(ranks.WHOLE_KV)}
    inputs["prompts"] = PROMPTS
    started = []
    for program, world in ((ranks.program_two, 2), (ranks.program_four, 4)):
        workdir = tmp_path_factory.mktemp(program.__name__)
        with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
            pickle.dump(inputs, f)
        started.append((_start(workdir, program, world), workdir, world))
    deadline = time.monotonic() + 240
    try:
        for arch in ranks.TRAIN_ARCHS + tuple(ranks.WHOLE_KV):
            _repro_grads(arch)
        for _, case in KV_CASES:
            _repro_chain(case)
        for arch in ranks.ENGINE_SLOTS:
            _repro_engine(arch)
        _repro_adafactor()
    finally:
        outs = [_join(ctx, workdir, world, deadline) for ctx, workdir, world in started]
    return outs


@pytest.fixture(scope="module")
def two(groups):
    return groups[0]


@pytest.fixture(scope="module")
def four(groups):
    return groups[1]


def _runs(mesh, two, four):
    """(mesh shape, each rank's (data, model) coordinates and output)."""
    shape = MESHES[mesh]
    group = four if math.prod(shape) == 4 else two
    return shape, [(divmod(r, shape[1]), out[mesh]) for r, out in group.items()]


# -- sequence-parallel training ------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _repro_grads(arch):
    jmodel, jparams = _repro(arch)
    batch = {k: jnp.asarray(v) for k, v in ranks.train_batch(arch).items()}
    with j_gemm_context(backend="xla"):
        loss, grads = jax.jit(jax.value_and_grad(lambda p, b: jmodel.loss_fn(p, b)[0]))(
            jax.tree.map(jnp.asarray, jparams), batch)
    return float(loss), dict(tree_items(jax.tree.map(np.asarray, grads)))


@pytest.mark.parametrize("mesh,arch", [(mesh, arch) for mesh in ("1x2", "2x2")
                                       for arch in ranks.TRAIN_ARCHS]
                         + [("1x4", case) for case in ranks.WHOLE_KV])
def test_sequence_parallel_step_matches_jax_grad(two, four, mesh, arch):
    loss, want = _repro_grads(arch)
    _, runs = _runs(mesh, two, four)
    for _, run in runs:
        got = run["grads"][arch]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-4)
        # the norms ran on each rank's positions: their gradients were summed
        # (whisper's encoder and decoder both run sequence-parallel)
        assert got["seq_leaves"] and all("norm" in name for name in got["seq_leaves"])
        assert "final_norm/scale" in got["seq_leaves"]
        if arch == "whisper-large-v3":
            assert "enc_final_norm/scale" in got["seq_leaves"]
        flat = dict(tree_items(got["grads"]))
        assert sorted(flat) == sorted(want)
        for name, ref in want.items():
            np.testing.assert_allclose(flat[name], ref, rtol=0,
                                       atol=1e-4 * max(np.abs(ref).max(), 1e-30), err_msg=name)


def _host_cell(arch, shape_name, mesh, batch, seq):
    return dryrun.lower_cell(arch, shape_name, False, mesh_shape=mesh,
                             config_overrides=dataclasses.asdict(ranks.config_of(arch)),
                             shape_overrides={"global_batch": batch, "seq_len": seq})


def test_train_step_collectives_equal_the_dry_runs_sequence_parallel_record(two):
    art = _host_cell("granite-8b", "train_4k", (1, 2), ranks.TRAIN_BATCH, ranks.TRAIN_SEQ)
    assert art["config"]["rules"] == {"seq": "model"}
    coll = art["collectives"]
    # the stream's gathers and scatters; the all-reduces are the norms'
    # gradients and scalars, each smaller than one residual
    assert coll["reduce-scatter"]["count"] and coll["all-gather"]["count"]
    cfg = ranks.config_of("granite-8b")
    residual = ranks.TRAIN_BATCH * ranks.TRAIN_SEQ // 2 * cfg.d_model * 4
    assert coll["all-reduce"]["bytes"] < residual
    for _, run in _runs("1x2", two, None)[1]:
        assert run["train_record"] == coll


# -- kv_seq decode ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _repro_chain(case):
    """``repro``'s prefill logits and greedy decode chain on one device, and
    its prefill cache (numpy)."""
    jmodel, jparams = _repro(case)
    params = jax.tree.map(jnp.asarray, jparams)
    tokens = jnp.asarray(ranks.decode_tokens(case))
    with j_gemm_context(backend="xla"):
        logits, cache = jmodel.prefill(params, tokens, max_seq=ranks.CACHE_SEQ)
        prefill_cache = jax.tree.map(np.asarray, cache)
        chain = [np.asarray(logits)]
        pos = jnp.full((tokens.shape[0],), tokens.shape[1])
        for _ in range(ranks.DECODE_STEPS):
            nxt = jnp.argmax(logits[:, -1], axis=-1)[:, None]
            logits, cache = jmodel.decode_step(params, cache, nxt, pos)
            chain.append(np.asarray(logits))
            pos = pos + 1
    return chain, prefill_cache


KV_CASES = [("1x4", "granite-8b"), ("1x4", "granite-8b/int8"), ("2x1", "zamba2-1.2b")]


@pytest.mark.parametrize("mesh,case", KV_CASES)
def test_kv_seq_decode_logits_match_repros_one_device_model(two, four, mesh, case):
    want, _ = _repro_chain(case)
    _, runs = _runs(mesh, two, four)
    for _, run in runs:
        chain = run["decode"][case]["chain"]
        assert len(chain) == len(want) == ranks.DECODE_STEPS + 1
        for got, ref in zip(chain, want):
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def _repro_local(jspec, shape, rules, coords):
    """(local shape, the rank's slices) of a ``repro`` cache spec under
    ``repro``'s own plan with ``rules`` on a ``shape`` mesh, for the rank at
    ``coords``."""
    plan = j_sharding.ShardingPlan(MeshShape(shape, ("data", "model")), rules)
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


@pytest.mark.parametrize("mesh,case", KV_CASES)
def test_kv_seq_cache_shards_are_repros_cache_sliced(two, four, mesh, case):
    _, want = _repro_chain(case)
    shape, runs = _runs(mesh, two, four)
    rows = ranks.DECODE[case][3]
    rules = ranks.cell_rules(case, ranks.DECODE[case][2], shape)
    specs = _repro(case)[0].cache_specs(rows, ranks.CACHE_SEQ)
    cfg = ranks.config_of(case)
    # the hybrid writes its shared block's rows at the layers that run it
    # (repro at every layer, and reads those alone)
    layers = [i for i in range(cfg.n_layers)
              if not cfg.attn_every or i % cfg.attn_every == cfg.attn_every - 1]
    seen = set()
    for coords, run in runs:
        got = run["decode"][case]["cache"]
        assert sorted(got) == sorted(specs)
        for group, leaves in specs.items():
            for key, jspec in leaves.items():
                local, slices = _repro_local(jspec, shape, rules, coords)
                assert got[group][key].shape == local, (group, key)
                full = want[group][key].astype(np.float32)[slices]
                mine = got[group][key].astype(np.float32)
                if group == "attn":
                    full, mine = full[layers], mine[layers]
                np.testing.assert_allclose(mine, full, rtol=0,
                                           atol=1e-4 * max(np.abs(full).max(), 1e-30))
                if group == "attn" and key == "k":
                    seen.add(slices[2].start)
    # every rank holds its own range of the positions
    assert len(seen) == len(runs)


@functools.lru_cache(maxsize=None)
def _repro_engine(arch):
    jmodel, jparams = _repro(arch)
    jeng = JServeEngine(jmodel, jax.tree.map(jnp.asarray, jparams),
                        JServeConfig(n_slots=ranks.ENGINE_SLOTS[arch], max_seq=ranks.ENGINE_SEQ,
                                     eos=-1))
    with j_gemm_context(backend="xla"):
        for p in PROMPTS:
            jeng.submit(p, max_new_tokens=ranks.ENGINE_NEW)
        return {r.uid: r.out_tokens for r in jeng.run()}


@pytest.mark.parametrize("mesh,arch", [("1x4", "granite-8b"), ("2x1", "zamba2-1.2b")])
def test_engine_greedy_tokens_under_kv_seq_match_repros_engine(two, four, mesh, arch):
    want = _repro_engine(arch)
    assert len(want) == len(PROMPTS) > ranks.ENGINE_SLOTS[arch]
    _, runs = _runs(mesh, two, four)
    cfg = ranks.config_of(arch)
    for _, run in runs:
        engine = run["engine"][arch]
        assert engine["tokens"] == want
        # the slots' cache holds each rank's quarter (half) of the positions
        n_layers = cfg.n_layers
        assert engine["attn_shape"][:3] == (n_layers, ranks.ENGINE_SLOTS[arch],
                                            ranks.ENGINE_SEQ // math.prod(MESHES[mesh]))


@pytest.mark.parametrize("mesh,case,shape_name", [("1x4", "granite-8b", "decode_32k"),
                                                  ("2x1", "zamba2-1.2b", "long_500k")])
def test_kv_seq_decode_collectives_equal_the_dry_runs(two, four, mesh, case, shape_name):
    shape, runs = _runs(mesh, two, four)
    where = ranks.RECORD_POS[case]
    art = _host_cell(case, shape_name, shape, len(where), ranks.RECORD_SEQ)
    rules = ranks.cell_rules(case, shape_name, shape)
    assert art["config"]["rules"] == {k: list(v) if isinstance(v, tuple) else v
                                      for k, v in rules.items()}
    want = art["collectives"]
    for _, run in runs:
        assert run["decode"][case]["record"] == want
    cfg = ranks.config_of(case)
    attn_layers = cfg.n_layers if cfg.family == "dense" else cfg.n_layers // cfg.attn_every
    # each attention layer: the max all-reduce and the one sum all-reduce of
    # the partial softmaxes, beside the row-parallel sums
    assert want["all-reduce"]["count"] >= 2 * attn_layers
    if case == "granite-8b":  # kv_seq rides model: the query all-gathered a layer
        assert want["all-gather"]["count"] == attn_layers + 1  # + the logits'


# -- Adafactor -----------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _repro_adafactor():
    jmodel, jparams = _repro("granite-8b")
    opt = j_make_optimizer("adafactor", j_warmup_cosine(3e-3, 1, 2 * ranks.ADAFACTOR_STEPS))
    state = j_init_train_state(jmodel, opt, jax.tree.map(jnp.asarray, jparams))
    step = jax.jit(j_make_train_step(jmodel, opt))
    losses = []
    with j_gemm_context(backend="xla"):
        for i in range(ranks.ADAFACTOR_STEPS):
            batch = {k: jnp.asarray(v) for k, v in ranks.train_batch("granite-8b", i).items()}
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
    opt_state = {k: v for k, v in state["opt"].items() if k != "count"}
    return (losses, dict(tree_items(jax.tree.map(np.asarray, state["params"]))),
            dict(tree_items(jax.tree.map(np.asarray, opt_state))))


@pytest.mark.parametrize("mesh", ["1x2", "2x1"])
def test_adafactor_across_ranks_matches_repros_one_device(two, mesh):
    losses, params, opt = _repro_adafactor()
    _, runs = _runs(mesh, two, None)
    for _, run in runs:
        got = run["adafactor"]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        for want, tree in ((params, got["params"]), (opt, got["opt"])):
            flat = dict(tree_items(tree))
            assert sorted(flat) == sorted(want)
            for name, ref in want.items():
                np.testing.assert_allclose(flat[name], ref, rtol=1e-5,
                                           atol=1e-5 * max(np.abs(ref).max(), 1e-30),
                                           err_msg=name)
        assert any(name.endswith("/vr") for name in dict(tree_items(got["opt"])))


# -- in-process checks -----------------------------------------------------------------------


def test_paged_engine_and_an_undivided_cache_refuse_a_kv_seq_plan():
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import virtual_mesh
    from repro_torch.models import build_model
    from repro_torch.serve.paged_kv import PagedKVCache

    model = build_model(ranks.config_of("granite-8b"))
    rules = ranks.cell_rules("granite-8b", "decode_32k", (1, 4))
    assert rules == {"kv_heads": None, "kv_seq": ("pod", "data", "model")}
    with sharding.use_plan(sharding.ShardingPlan(virtual_mesh((1, 4)), rules)):
        with pytest.raises(NotImplementedError, match="kv_seq rule"):
            PagedKVCache(model, page_size=8, n_pages=4, device="cpu")
        # 18 positions do not split four ways: the layers would misread them
        with pytest.raises(ValueError, match="do not split over the kv_seq axes"):
            model.init_cache(2, 18, device="cpu")
        split = sharding.kv_seq_split(None, 2)
        assert (split.axes, split.n, split.index) == (("model",), 4, 0)
        assert model.init_cache(2, 16, device="cpu")["attn"]["k"].shape[2] == 4
