"""The four dense and MoE configs the port adds beside granite-8b and
olmoe-1b-7b, against ``repro`` on the CPU: nemotron-4-15b (squared-ReLU
MLP), gemma3-27b (5:1 local:global sliding windows, ring caches, a tied
head), mistral-large-123b and qwen3-moe-235b-a22b (128 experts top-8), each
reduced and in f32, with ``repro``'s parameters carried across by
``params_from_jax``.

* Configs: every ``FULL`` and ``reduced()`` field for field, the derived
  properties, ``param_count()``/``active_param_count()`` for all of
  ``repro``'s configs (and the instantiated tree's count for the port's),
  the shape cells and ``applicable_shapes``; ``build_model`` builds all ten
  (``LM``, or ``EncDec`` for whisper), each reduced tree counting
  ``param_count()``.
* Each new arch: parameters carried across exactly; ``forward`` logits
  within 1e-4 x max|logit| of ``repro``'s (aux loss too), prefill logits
  and cache rows within 1e-4, and the same greedy tokens as ``repro``'s
  ``ServeEngine`` — through the ``torch`` backend and the ``cuda`` one (the
  kernels' plain versions on CPU tensors).
* gemma3 (window 8, every third layer global, prompts longer than 8 so the
  local layers mask): a decode chain from an empty ring cache and the
  uniform prefill -> ``windowed_cache_from_uniform`` -> windowed decode
  handoff equal ``forward`` (``tests/test_perf_variants.py``'s tolerance,
  2e-3); the ring caches equal ``repro``'s leaf for leaf; the tied head is
  built once per embedding; the serve CLI gives ``repro``'s CLI's tokens.
* qwen3-moe: a layer's router logits and ``moe_apply`` output and aux loss
  against ``repro``'s.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.config as j_config_mod
from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.configs import list_archs as j_list_archs
from repro.core.gemm import gemm_context as j_gemm_context
from repro.dist.sharding import materialize_tree
from repro.models import build_model as j_build_model
from repro.launch import serve as j_serve
from repro.models import layers as j_layers
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.core.gemm import gemm, gemm_context
from repro_torch.launch import serve as t_serve
from repro_torch.models import build_model
from repro_torch.models import config as t_config_mod
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import LM, params_from_jax
from repro_torch.serve.engine import ServeConfig, ServeEngine

NEW_ARCHS = ["nemotron-4-15b", "gemma3-27b", "mistral-large-123b", "qwen3-moe-235b-a22b"]
PORT_ARCHS = sorted(["granite-8b", "olmoe-1b-7b"] + NEW_ARCHS)
BACKENDS = ["torch", "cuda"]
#: prompts longer than gemma3-reduced's window of 8, and one shorter
PROMPTS = [np.array(p, np.int32) for p in (list(range(3, 17)), [200, 1, 64, 9, 77],
                                           list(range(100, 123)))]


@functools.lru_cache(maxsize=None)
def _pair(arch):
    jcfg = dataclasses.replace(j_get_reduced(arch), dtype="float32")
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jmodel = j_build_model(jcfg)
    jparams = materialize_tree(jmodel.param_specs(), jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, build_model(cfg), params


@functools.lru_cache(maxsize=None)
def _repro_outputs(arch):
    """``repro``'s forward (logits, aux) of a (2, 14) batch, the prefill
    (logits, cache) of a prompt longer than gemma3-reduced's window and of a
    shorter one, and its engine's greedy tokens, once per arch for both of
    the port's backends."""
    jmodel, jparams, model, _ = _pair(arch)
    toks = np.random.default_rng(4).integers(0, model.cfg.vocab_size, (2, 14))
    forward = jmodel.forward(jparams, jnp.asarray(toks))
    prefills = [jmodel.prefill(jparams, jnp.asarray(p)[None], max_seq=32) for p in PROMPTS[:2]]
    jeng = JServeEngine(jmodel, jparams, JServeConfig(n_slots=2, max_seq=40, eos=-1))
    with j_gemm_context(backend="xla"):
        for p in PROMPTS:
            jeng.submit(p, max_new_tokens=6)
        tokens = {r.uid: r.out_tokens for r in jeng.run()}
    return toks, forward, prefills, tokens


def _count(tree):
    if isinstance(tree, dict):
        return sum(_count(v) for v in tree.values())
    return tree.numel()


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * np.abs(want).max())


# -- configs -------------------------------------------------------------------


def test_port_registers_the_six_archs():
    """The six dense and MoE archs, among all ten of ``repro``'s."""
    assert set(PORT_ARCHS) <= set(list_archs())
    assert list_archs() == sorted(j_list_archs())


@pytest.mark.parametrize("arch", PORT_ARCHS)
def test_full_and_reduced_match_repro(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(j_get_config(arch))
    assert dataclasses.asdict(get_reduced(arch)) == dataclasses.asdict(j_get_reduced(arch))


@pytest.mark.parametrize("arch", j_list_archs())
def test_derived_properties_and_param_counts_match_repro(arch):
    for jcfg in (j_get_config(arch), j_get_reduced(arch)):
        cfg = ModelConfig(**dataclasses.asdict(jcfg))
        for prop in ("is_attention_free", "d_inner", "ssm_heads", "supports_long_context"):
            assert getattr(cfg, prop) == getattr(jcfg, prop), prop
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        assert ([dataclasses.asdict(s) for s in t_config_mod.applicable_shapes(cfg)]
                == [dataclasses.asdict(s) for s in j_config_mod.applicable_shapes(jcfg)])


def test_shape_cells_match_repro():
    assert [dataclasses.asdict(s) for s in t_config_mod.ALL_SHAPES] == [
        dataclasses.asdict(s) for s in j_config_mod.ALL_SHAPES]
    assert {k: dataclasses.asdict(s) for k, s in t_config_mod.SHAPES_BY_NAME.items()} == {
        k: dataclasses.asdict(s) for k, s in j_config_mod.SHAPES_BY_NAME.items()}
    for name in ("TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K"):
        assert dataclasses.asdict(getattr(t_config_mod, name)) == dataclasses.asdict(
            getattr(j_config_mod, name))


@pytest.mark.parametrize("arch", PORT_ARCHS)
def test_instantiated_tree_counts_param_count(arch):
    model = LM(get_reduced(arch))
    params = model.init_params("cpu")
    assert _count(params) == model.cfg.param_count()
    assert model.cfg.active_param_count() <= model.cfg.param_count()
    assert ("lm_head" in params) == (not model.cfg.tie_embeddings)


@pytest.mark.parametrize("arch", j_list_archs())
def test_build_model_builds_every_arch(arch):
    from repro_torch.models.encdec import EncDec

    cfg = ModelConfig(**dataclasses.asdict(j_get_reduced(arch)))
    model = build_model(cfg)
    assert type(model) is (EncDec if cfg.family == "encdec" else LM)
    assert _count(model.init_params("cpu")) == cfg.param_count()


# -- the new archs against repro --------------------------------------------------


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_params_carry_across_exactly(arch):
    jmodel, jparams, model, params = _pair(arch)
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert _count(params) == model.cfg.param_count() == sum(np.size(v) for _, v in flat_j)
    for path, leaf in flat_j:
        node = params
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_and_prefill_match_repro(arch, backend):
    model, params = _pair(arch)[2:]
    toks, (want, want_aux), prefills, _ = _repro_outputs(arch)
    with gemm_context(backend=backend, device="cpu"):
        got, aux = model.forward(params, torch.from_numpy(toks))
    _close(got, want, 1e-4)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-5, atol=1e-7)
    for prompt, (want, jcache) in zip(PROMPTS, prefills):
        with gemm_context(backend=backend, device="cpu"):
            got, cache = model.prefill(params, torch.from_numpy(prompt).long()[None], max_seq=32)
        _close(got, want, 1e-4)
        for key in "kv":
            np.testing.assert_allclose(cache["attn"][key].numpy(),
                                       np.asarray(jcache["attn"][key]), rtol=0, atol=1e-4)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_serve_engine_greedy_tokens_match_repro(arch, backend):
    model, params = _pair(arch)[2:]
    jdone = _repro_outputs(arch)[3]
    eng = ServeEngine(model, params, ServeConfig(n_slots=2, max_seq=40, eos=-1),
                      backend=backend, device="cpu")
    for p in PROMPTS:
        eng.submit(p, max_new_tokens=6)
    done = {r.uid: r.out_tokens for r in eng.run()}
    assert len(done) == 3 and not eng.exhausted and done == jdone
    tags = {e.tag for e in eng.selection_log}
    assert "lm_head" in tags and ("moe.router" in tags) == (model.cfg.family == "moe")
    if model.cfg.mlp_act == "squared_relu":
        assert {e.op.epilogue.activation for e in eng.selection_log if e.tag == "mlp.in"} == {
            "square"}


def test_serve_cli_gemma3_tokens_match_repro_cli(monkeypatch):
    """The serve CLI on reduced gemma3-27b (sliding windows, tied head) on the
    CPU against ``repro``'s CLI with the same flags: the same greedy tokens.
    The port draws its weights with a ``torch.Generator``, so here both CLIs
    are given ``repro``'s seeded weights (``materialize_tree`` of
    ``PRNGKey(seed)``, carried across); the prompts come from the same numpy
    seed in both. f32, so no bf16 rounding tells the two apart."""
    import sys

    from repro.serve.engine import EngineCore as JEngineCore
    from repro_torch.serve.engine import EngineCore

    argv = ["--arch", "gemma3-27b", "--preset", "reduced", "--dtype", "float32", "--requests",
            "4", "--slots", "2", "--max-seq", "48", "--max-new-tokens", "6", "--seed", "0"]
    tokens = {}

    def recording(cls, side):
        run = cls.run

        def wrapped(self, *a, **kw):
            done = run(self, *a, **kw)
            tokens.setdefault(side, {}).update({r.uid: list(r.out_tokens) for r in done})
            return done
        monkeypatch.setattr(cls, "run", wrapped)

    def repro_weights(self, device=None, generator=None):
        jcfg = dataclasses.replace(j_get_reduced("gemma3-27b"), dtype="float32")
        jtree = materialize_tree(j_build_model(jcfg).param_specs(), jax.random.PRNGKey(0))
        return params_from_jax(jax.tree.map(np.asarray, jtree), device=device)

    recording(JEngineCore, "repro")
    recording(EngineCore, "port")
    monkeypatch.setattr(LM, "init_params", repro_weights)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    assert j_serve.main() == 0
    assert t_serve.main(argv + ["--device", "cpu"]) == 0
    assert len(tokens["port"]) == 4 and all(len(t) == 6 for t in tokens["port"].values())
    assert tokens["port"] == tokens["repro"]


# -- gemma3: windows, ring caches, the tied head ------------------------------------


@pytest.fixture(scope="module")
def gemma3():
    jmodel, jparams, model, params = _pair("gemma3-27b")
    cfg = model.cfg
    assert cfg.window == 8 and cfg.global_every == 3 and cfg.tie_embeddings
    ring = LM(dataclasses.replace(cfg, window_cache=True))
    jring = j_build_model(dataclasses.replace(jmodel.cfg, window_cache=True))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    full, _ = model.forward(params, torch.from_numpy(toks))
    return dict(jmodel=jmodel, jparams=jparams, model=model, params=params, ring=ring,
                jring=jring, toks=toks, full=full)


def test_layer_flags_and_windows(gemma3):
    model = gemma3["model"]
    assert model.layer_flags()["is_global"] == [False, False, True, False, False, True]
    np.testing.assert_array_equal(
        np.asarray(gemma3["jmodel"].layer_flags()["is_global"]), model.layer_flags()["is_global"])
    assert [w for _, w in model._windows()] == [8, 8, 2**30, 8, 8, 2**30]
    # the window masks: the same prompt with every layer global reads differently
    everywhere = LM(dataclasses.replace(model.cfg, window=0))
    toks = torch.from_numpy(gemma3["toks"])
    assert (everywhere.forward(gemma3["params"], toks)[0] - gemma3["full"]).abs().max() > 1e-3


@pytest.mark.parametrize("backend", BACKENDS)
def test_ring_decode_chain_from_empty_equals_forward(gemma3, backend):
    ring, params, toks, full = gemma3["ring"], gemma3["params"], gemma3["toks"], gemma3["full"]
    b, s = toks.shape
    cache = ring.init_cache(b, s, device="cpu")
    assert cache["local"]["k"].shape == (4, b, 8, 2, 16)
    assert cache["global"]["k"].shape == (2, b, s, 2, 16)
    with gemm_context(backend=backend, device="cpu"):
        for t in range(s):
            logits, cache = ring.decode_step(params, cache, torch.from_numpy(toks[:, t:t + 1]),
                                             torch.full((b,), t))
            np.testing.assert_allclose(logits[:, 0].numpy(), full[:, t].numpy(), rtol=2e-3,
                                       atol=2e-3)


@pytest.mark.parametrize("backend", BACKENDS)
def test_uniform_prefill_windowed_handoff_equals_forward(gemma3, backend):
    model, ring, params = gemma3["model"], gemma3["ring"], gemma3["params"]
    toks, full = gemma3["toks"], gemma3["full"]
    b, s = toks.shape
    p0 = s - 4
    with gemm_context(backend=backend, device="cpu"):
        _, ucache = model.prefill(params, torch.from_numpy(toks[:, :p0]), max_seq=s)
        wcache = ring.windowed_cache_from_uniform(ucache, p0)
        for t in range(p0, s):
            logits, wcache = ring.decode_step(params, wcache, torch.from_numpy(toks[:, t:t + 1]),
                                              torch.full((b,), t))
            np.testing.assert_allclose(logits[:, 0].numpy(), full[:, t].numpy(), rtol=2e-3,
                                       atol=2e-3)


@pytest.mark.parametrize("prompt_len", [5, 12])
def test_ring_cache_matches_repro_leaf_for_leaf(gemma3, prompt_len):
    """The handoff's ring caches (cold slots at 5 < 8, wrapped at 12), then
    after two windowed decode steps, against ``repro``'s."""
    model, ring, params = gemma3["model"], gemma3["ring"], gemma3["params"]
    jmodel, jring, jparams = gemma3["jmodel"], gemma3["jring"], gemma3["jparams"]
    toks = gemma3["toks"]
    b, s = toks.shape
    _, ucache = model.prefill(params, torch.from_numpy(toks[:, :prompt_len]), max_seq=s)
    _, jucache = jmodel.prefill(jparams, jnp.asarray(toks[:, :prompt_len]), max_seq=s)
    wcache = ring.windowed_cache_from_uniform(ucache, prompt_len)
    jwcache = jring.windowed_cache_from_uniform(jucache, prompt_len)

    def same(got, want):
        assert set(got) == set(want) == {"local", "global"}
        for part in got:
            assert set(got[part]) == set(want[part]) == {"k", "v"}
            for key in "kv":
                assert tuple(got[part][key].shape) == want[part][key].shape
                np.testing.assert_allclose(got[part][key].numpy(), np.asarray(want[part][key]),
                                           rtol=0, atol=1e-4)

    same(wcache, jwcache)
    with j_gemm_context(backend="xla"):
        for t in range(prompt_len, prompt_len + 2):
            tok, pos = toks[:, t:t + 1], np.full((b,), t)
            _, wcache = ring.decode_step(params, wcache, torch.from_numpy(tok),
                                         torch.from_numpy(pos))
            _, jwcache = jring.decode_step(jparams, jwcache, jnp.asarray(tok), jnp.asarray(pos))
    same(wcache, jwcache)


def test_windowed_cache_refuses_chunked_prefill(gemma3):
    ring = gemma3["ring"]
    with pytest.raises(ValueError, match="uniform decode cache"):
        ring.prefill_chunk(gemma3["params"], None, torch.zeros(1, 2, dtype=torch.long),
                           torch.tensor([0]))


def test_tied_head_is_built_once_per_embedding(gemma3):
    model, params = LM(gemma3["model"].cfg), gemma3["params"]
    assert "lm_head" not in params and "lm_head" not in model.param_specs()
    head = model.head_weight(params)
    assert head.is_contiguous() and tuple(head.shape) == (64, 256)
    torch.testing.assert_close(head, params["embed"].T, rtol=0, atol=0)
    toks = torch.from_numpy(gemma3["toks"])
    model.forward(params, toks)
    model.decode_step(params, model.init_cache(2, 4, device="cpu"), toks[:, :1],
                      torch.zeros(2, dtype=torch.long))
    assert model.head_weight(params) is head  # reused on every dispatch
    other = dict(params, embed=params["embed"].clone())
    rebuilt = model.head_weight(other)
    assert rebuilt is not head and model.head_weight(other) is rebuilt
    other["embed"].mul_(2.0)  # an in-place write moves the version: rebuilt
    torch.testing.assert_close(model.head_weight(other), other["embed"].T, rtol=0, atol=0)
    qparams, n_quant, _ = model.quantize_weights(params)
    assert n_quant == 7 and qparams["embed"] is params["embed"]  # the 7 stacked projections
    assert model.head_weight(qparams).dtype == torch.float32


# -- qwen3-moe: one MoE layer against repro --------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_qwen3_moe_layer_matches_repro(backend):
    jmodel, jparams, model, params = _pair("qwen3-moe-235b-a22b")
    cfg = model.cfg
    jp = jax.tree.map(lambda a: a[1], jparams["layers"]["moe"])
    p = {k: v[1] for k, v in params["layers"]["moe"].items()}
    x = np.random.default_rng(5).normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    with j_gemm_context(backend="xla"):
        want, want_aux = j_layers.moe_apply(jp, jnp.asarray(x), jmodel.cfg, div={})
    want_router = np.asarray(jnp.asarray(x).reshape(-1, cfg.d_model) @ jp["router"])
    with gemm_context(backend=backend, device="cpu") as ctx:
        router = gemm(torch.from_numpy(x).reshape(-1, cfg.d_model), p["router"],
                      tag="moe.router")
        got, aux = layers.moe_apply(p, torch.from_numpy(x), cfg, div={})
    _close(router, want_router, 1e-5)
    _close(got, want, 1e-4)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-5)
    assert [e.tag for e in ctx.log] == ["moe.router"] * 2 + ["moe.gate", "moe.in", "moe.out"]
    assert all(e.op.fused and e.op.g == cfg.n_experts for e in ctx.log[2:])
