"""The int8 KV cache (``kv_cache_dtype="int8"``) of the port against
``repro``'s, on the CPU: reduced granite-8b and olmoe-1b-7b in f32 with
``repro``'s parameters carried across by ``params_from_jax``.

* ``kv_quantize``/``kv_dequantize`` give the same bytes as ``repro``'s on
  the same inputs, ties that half-to-even rounding decides and an all-zero
  head included.
* After prefill and after each of two decode steps, every row the port
  wrote into its cache holds exactly the bytes ``repro``'s ``kv_quantize``
  makes of that row, and the cache's int8 codes equal ``repro``'s cache
  byte for byte. Its f32 scales agree with ``repro``'s to 1e-6 relative:
  the two packages' K/V rows themselves differ in their last bits (the
  RMS norm and RoPE round differently), and a scale is the row's amax / 127.
* Decode logits agree within 1e-4 x max|logit| (f32 sums in other orders),
  through the ``torch`` backend and the ``cuda`` backend's plain versions;
  ``ServeEngine`` emits the same greedy tokens as ``repro``'s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.core.gemm import gemm_context as j_gemm_context
from repro.dist.sharding import materialize_tree
from repro.models import layers as j_layers
from repro.models.lm import LM as JLM
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_reduced
from repro_torch.core.gemm import gemm_context
from repro_torch.models import layers
from repro_torch.models.lm import LM, params_from_jax
from repro_torch.serve.engine import ServeConfig, ServeEngine

ARCHS = ["granite-8b", "olmoe-1b-7b"]
PROMPT = np.array([5, 17, 3, 99, 42, 7, 11, 2, 8], np.int32)
PROMPTS = [np.array(p, np.int32)
           for p in ([5, 17, 3, 99, 42, 7], [200, 1, 64], list(range(30, 41)))]
MAX_SEQ = 16


def _int8_cfgs(arch):
    jcfg = dataclasses.replace(j_get_reduced(arch), dtype="float32", kv_cache_dtype="int8")
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32", kv_cache_dtype="int8")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    jcfg, cfg = _int8_cfgs(request.param)
    jmodel = JLM(jcfg)
    jparams = materialize_tree(jmodel.param_specs(), jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, LM(cfg), params


def _same_bytes(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype and got.shape == want.shape
    assert got.numpy().tobytes() == want.tobytes()


def _kv_inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 4, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero head: scale 1e-8 / 127, codes 0
    # amax 127 gives scale 1.0 exactly, so x / scale lands on .5 ties that
    # half-to-even rounding decides (0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -2.5 -> -2)
    x[0, 0, 1] = [127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5, -126.5, 4.5, 5.5, -3.5,
                  -4.5, 0, -127]
    x[0, 1, 2] *= 1e-12  # tiny values
    x[1] *= 300.0
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quantize_matches_repro_bytes(dtype):
    x = _kv_inputs()
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = j_layers.kv_quantize(jx)
    q, s = layers.kv_quantize(tx)
    _same_bytes(q, jq)
    _same_bytes(s, js)
    assert q[0, 0, 1].tolist() == [127, 0, 2, 2, 0, -2, -2, 4, 126, -126, 4, 6, -4, -4, 0, -127]
    assert not q[0, 0, 0].any()
    for out in ("float32", "bfloat16"):
        want = j_layers.kv_dequantize(jq, js, out)
        got = layers.kv_dequantize(q, s, getattr(torch, out))
        if out == "bfloat16":
            want, got = np.asarray(want).view(np.int16), got.view(torch.int16)
        _same_bytes(got, want)


def _recording(monkeypatch):
    """Record every (row block, codes, scales) the port's kv_quantize makes."""
    calls = []
    quantize = layers.kv_quantize

    def wrapped(x):
        q, s = quantize(x)
        calls.append((x.clone(), q, s))
        return q, s

    monkeypatch.setattr(layers, "kv_quantize", wrapped)
    return calls


def _check_rows(calls):
    """Each row block the port quantized gives repro's bytes."""
    assert calls
    for x, q, s in calls:
        jq, js = j_layers.kv_quantize(jnp.asarray(x.numpy()))
        _same_bytes(q, jq)
        _same_bytes(s, js)


def _check_cache(cache, jcache):
    for key in ("k", "v"):
        _same_bytes(cache["attn"][key], jcache["attn"][key])
        want = np.asarray(jcache["attn"][f"{key}_scale"])
        got = cache["attn"][f"{key}_scale"].numpy()
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_int8_cache_and_decode_logits_match_repro(pair, backend, monkeypatch):
    jmodel, jparams, model, params = pair
    calls = _recording(monkeypatch)
    jlogits, jcache = jmodel.prefill(jparams, jnp.asarray(PROMPT)[None], max_seq=MAX_SEQ)
    with gemm_context(backend=backend, device="cpu"):
        logits, cache = model.prefill(params, torch.from_numpy(PROMPT).long()[None],
                                      max_seq=MAX_SEQ)
    assert {k: v.dtype for k, v in cache["attn"].items()} == {
        "k": torch.int8, "v": torch.int8, "k_scale": torch.float32, "v_scale": torch.float32}
    # one call per layer and per K/V: the prompt's rows
    assert len(calls) == 2 * model.cfg.n_layers
    _check_rows(calls)
    _check_cache(cache, jcache)
    pos = len(PROMPT)
    for _ in range(2):
        tok = int(np.argmax(np.asarray(jlogits)[0, -1]))
        calls.clear()
        jlogits, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray([[tok]]),
                                             jnp.asarray([pos]))
        with gemm_context(backend=backend, device="cpu"):
            logits, cache = model.decode_step(params, cache, torch.tensor([[tok]]),
                                              torch.tensor([pos]))
        assert len(calls) == 2 * model.cfg.n_layers
        _check_rows(calls)
        _check_cache(cache, jcache)
        want = np.asarray(jlogits)
        np.testing.assert_allclose(logits.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
        pos += 1


def test_serve_engine_int8_cache_greedy_tokens_identical(pair):
    jmodel, jparams, model, params = pair
    jeng = JServeEngine(jmodel, jparams, JServeConfig(n_slots=2, max_seq=MAX_SEQ, eos=-1))
    eng = ServeEngine(model, params, ServeConfig(n_slots=2, max_seq=MAX_SEQ, eos=-1),
                      backend="cuda", device="cpu")
    with j_gemm_context(backend="xla"):
        for p in PROMPTS:
            jeng.submit(p, max_new_tokens=4)
        jdone = {r.uid: r.out_tokens for r in jeng.run()}
    for p in PROMPTS:
        eng.submit(p, max_new_tokens=4)
    done = {r.uid: r.out_tokens for r in eng.run()}
    assert len(done) == 3 and done == jdone
    assert eng.cache["attn"]["k"].dtype == torch.int8 and "v_scale" in eng.cache["attn"]


@pytest.mark.parametrize("bad", ["fp8", "int4", "bfloat16"])
def test_unknown_kv_cache_dtype_raises(bad):
    cfg = dataclasses.replace(get_reduced("granite-8b"), kv_cache_dtype=bad)
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        LM(cfg)
