"""The SSM, hybrid, VLM and encoder-decoder families of the port against
``repro`` on the CPU: mamba2-1.3b (the SSD block), zamba2-1.2b (Mamba2
layers and one shared attention and MLP block at every ``attn_every``-th
layer), llava-next-34b (stubbed patch embeddings before the text) and
whisper-large-v3 (the encoder-decoder), each reduced and in f32, with
``repro``'s parameters carried across by ``params_from_jax``.

* The SSD: ``_ssd_chunked`` against ``repro``'s at chunks 4, 8 and 16, with
  and without an initial state (1e-5 x max|ref|), and against a naive
  recurrence (1e-4); ``ssd_apply``'s prefill output, state and conv tail
  against ``repro``'s, on prompts padded to the chunk and shorter than the
  conv; the prefill state equal to a chain of decode steps.
* Each of the four models: ``forward`` logits, prefill logits and cache
  leaves (``ssm.h``, ``ssm.conv``, zamba2's marked attention rows,
  whisper's ``attn`` and ``cross``) and one decode step's logits within
  1e-4 x max|ref| of ``repro``'s; the port's prefill and decode steps
  against its own ``forward`` at 2e-3 (``tests/test_decode_consistency.py``'s
  tolerance) — through the ``torch`` backend and the ``cuda`` one (the
  kernels' plain versions on CPU tensors).
* Greedy tokens equal to ``repro``'s ``ServeEngine`` on mamba2, zamba2 and
  llava text prompts with more requests than slots (so slots are reused),
  and to a ``repro`` ``EncDec`` prefill and decode loop for whisper;
  mamba2 on the int8 rung equal to ``repro``'s.
* The serve CLI: mamba2 gives ``repro``'s CLI's tokens; whisper, and
  ``--paged`` on mamba2, are refused as ``repro``'s CLI refuses them.
"""

import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.core.gemm import gemm_context as j_gemm_context
from repro.dist.sharding import materialize_tree
from repro.launch import serve as j_serve
from repro.models import build_model as j_build_model
from repro.models import ssd as j_ssd
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_reduced
from repro_torch.core.gemm import gemm_context
from repro_torch.core.quant import QuantizedTensor
from repro_torch.launch import serve as t_serve
from repro_torch.models import build_model, ssd
from repro_torch.models.encdec import EncDec
from repro_torch.models.lm import LM, params_from_jax
from repro_torch.serve.engine import ServeConfig, ServeEngine

FAMILIES = ["mamba2-1.3b", "zamba2-1.2b", "llava-next-34b", "whisper-large-v3"]
DECODER_ONLY = FAMILIES[:3]
BACKENDS = ["torch", "cuda"]
#: serve prompts: one padded to the chunk (8 reduced), one shorter than the
#: conv's width - 1 (its tail left-padded), one longer than two chunks
PROMPTS = [np.array(p, np.int32) for p in (list(range(3, 14)), [200, 1], list(range(100, 119)),
                                           [7, 9, 11, 5, 3])]
B, S, S0 = 2, 16, 9  # the batch of forward, and the prompt length the decode chain starts at


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * np.abs(want).max())


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _arr(lib, a):
    """A numpy array as ``lib``'s: a jnp array, or a torch tensor (int64
    for integers)."""
    if lib is jnp:
        return jnp.asarray(a)
    return _t(a).long() if a.dtype.kind == "i" else _t(a)


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
def _inputs(arch):
    """The (B, S) tokens and the family's extra input: llava's patch
    embeddings (B, P, D), whisper's frames (B, F, D), else None."""
    cfg = get_reduced(arch)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    extra = None
    if cfg.family == "vlm":
        extra = (rng.normal(size=(B, cfg.n_patches, cfg.d_model)) * 0.5).astype(np.float32)
    elif cfg.family == "encdec":
        extra = rng.normal(size=(B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return toks, extra


def _run(model, params, toks, extra, *, steps, lib):
    """forward over ``toks``, prefill of its first ``S0`` tokens, then
    ``steps`` decode steps fed the next tokens, with ``lib`` jnp or torch.
    A VLM's position t >= P holds text token t - P. Returns (forward
    logits, prefill logits, prefill cache, each step's logits)."""
    arr = functools.partial(_arr, lib)
    fam = model.cfg.family
    p = model.cfg.n_patches if fam == "vlm" else 0
    x = None if extra is None else arr(extra)
    if fam == "encdec":
        full, _ = model.forward(params, x, arr(toks))
        logits, cache = model.prefill(params, x, arr(toks[:, :S0]), max_seq=S)
    elif fam == "vlm":
        full, _ = model.forward(params, arr(toks), patch_embeds=x)
        logits, cache = model.prefill(params, arr(toks[:, :S0]), max_seq=S, patch_embeds=x)
    else:
        full, _ = model.forward(params, arr(toks))
        logits, cache = model.prefill(params, arr(toks[:, :S0]), max_seq=S)
    out = []
    for t in range(S0, S0 + steps):
        step, cache = model.decode_step(params, cache, arr(toks[:, t - p:t - p + 1]),
                                        arr(np.full((B,), t)))
        out.append(np.array(step[:, 0]))
    return np.array(full), np.array(logits), cache, out


@functools.lru_cache(maxsize=None)
def _repro_run(arch):
    jmodel, jparams = _pair(arch)[:2]
    toks, extra = _inputs(arch)
    with j_gemm_context(backend="xla"):
        full, logits, cache, steps = _run(jmodel, jparams, toks, extra, steps=1, lib=jnp)
    return full, logits, jax.tree.map(np.asarray, cache), steps


@functools.lru_cache(maxsize=None)
def _repro_tokens(arch):
    """``repro``'s greedy tokens: its ``ServeEngine`` over ``PROMPTS``
    through 2 slots, or, for whisper, an ``EncDec`` prefill of two requests
    and a greedy decode loop."""
    jmodel, jparams = _pair(arch)[:2]
    with j_gemm_context(backend="xla"):
        if jmodel.cfg.family == "encdec":
            return _encdec_greedy(jmodel, jparams, jnp)
        jeng = JServeEngine(jmodel, jparams, JServeConfig(n_slots=2, max_seq=40, eos=-1))
        for p in PROMPTS:
            jeng.submit(p, max_new_tokens=6)
        return {r.uid: r.out_tokens for r in jeng.run()}


def _encdec_greedy(model, params, lib, new=6):
    toks, frames = _inputs("whisper-large-v3")
    arr = functools.partial(_arr, lib)
    logits, cache = model.prefill(params, arr(frames), arr(toks[:, :5]), max_seq=S)
    out = [np.asarray(logits[:, -1]).argmax(-1)]
    for i in range(new - 1):
        logits, cache = model.decode_step(params, cache, arr(out[-1][:, None]),
                                          arr(np.full((B,), 5 + i)))
        out.append(np.asarray(logits[:, -1]).argmax(-1))
    return np.stack(out, axis=1).tolist()


# -- the SSD ---------------------------------------------------------------------------------


def _ssd_inputs(seed=0, bsz=2, s=16, nh=3, dh=4, ds=5):
    r = np.random.default_rng(seed)
    return [r.normal(size=(bsz, s, nh, dh)).astype(np.float32),
            r.uniform(0.05, 0.5, size=(bsz, s, nh)).astype(np.float32),
            (-r.uniform(0.1, 2.0, size=(nh,))).astype(np.float32),
            r.normal(size=(bsz, s, ds)).astype(np.float32),
            r.normal(size=(bsz, s, ds)).astype(np.float32)]


def _naive_ssd(x, dt, a, b_in, c_in, h0=None):
    """h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t; y_t = C_t . h_t."""
    bsz, s, nh, dh = x.shape
    h = np.zeros((bsz, nh, dh, b_in.shape[-1]), np.float32) if h0 is None else h0.copy()
    ys = np.zeros(x.shape, np.float32)
    for t in range(s):
        h = (h * np.exp(dt[:, t] * a[None])[:, :, None, None]
             + np.einsum("bh,bs,bhd->bhds", dt[:, t], b_in[:, t], x[:, t]))
        ys[:, t] = np.einsum("bs,bhds->bhd", c_in[:, t], h)
    return ys, h


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_chunked_matches_repro(chunk, with_h0):
    args = _ssd_inputs(chunk)
    h0 = np.random.default_rng(9).normal(size=(2, 3, 4, 5)).astype(np.float32) if with_h0 \
        else None
    want_y, want_h = j_ssd._ssd_chunked(*map(jnp.asarray, args), chunk,
                                       None if h0 is None else jnp.asarray(h0))
    got_y, got_h = ssd._ssd_chunked(*map(_t, args), chunk, None if h0 is None else _t(h0))
    _close(got_y, want_y, 1e-5)
    _close(got_h, want_h, 1e-5)


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_chunked_matches_naive_recurrence(chunk):
    args = _ssd_inputs(1)
    h0 = np.random.default_rng(2).normal(size=(2, 3, 4, 5)).astype(np.float32)
    for start in (None, h0):
        want_y, want_h = _naive_ssd(*args, h0=start)
        got_y, got_h = ssd._ssd_chunked(*map(_t, args), chunk,
                                        None if start is None else _t(start))
        _close(got_y, want_y, 1e-4)
        _close(got_h, want_h, 1e-4)


def _ssm_layer0():
    jmodel, jparams, model, params = _pair("mamba2-1.3b")
    return (jmodel.cfg, jax.tree.map(lambda a: a[0], jparams["layers"])["ssm"],
            {k: v[0] for k, v in params["layers"]["ssm"].items()})


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("s", [2, 11])
def test_ssd_apply_prefill_matches_repro(s, backend):
    """Prompts shorter than the conv's width - 1 (2) and padded to the chunk
    (11 -> 16; ``forward`` runs whole chunks, 16)."""
    cfg, jp, p = _ssm_layer0()
    x = (np.random.default_rng(s).normal(size=(2, s, cfg.d_model)) * 0.5).astype(np.float32)
    with j_gemm_context(backend="xla"):
        want, jstate = j_ssd.ssd_apply(jp, jnp.asarray(x), cfg, div={})
    with gemm_context(backend=backend, device="cpu") as ctx:
        got, state = ssd.ssd_apply(p, _t(x), cfg, div={})
    assert [e.tag for e in ctx.log] == ["ssm.in", "ssm.out"]
    _close(got, want, 1e-4)
    for key in ("h", "conv"):
        assert tuple(state[key].shape) == jstate[key].shape
        _close(state[key], jstate[key], 1e-4)


def test_ssd_prefill_state_equals_decode_chain():
    """The chunked prefill's output and final state equal the decode
    recurrence run token by token from a zero state (2e-3, as ``repro``'s
    test), and the chain's steps equal ``repro``'s chain (1e-4)."""
    cfg, jp, p = _ssm_layer0()
    x = (np.random.default_rng(0).normal(size=(1, 11, cfg.d_model)) * 0.3).astype(np.float32)
    y_full, st_full = ssd.ssd_apply(p, _t(x), cfg, div={})
    st, jst = ssd.ssd_init_state(cfg, 1), j_ssd.ssd_init_state(cfg, 1)
    assert st["h"].dtype == torch.float32 and tuple(st["conv"].shape) == jst["conv"].shape
    ys = []
    with j_gemm_context(backend="xla"):
        for t in range(x.shape[1]):
            y_t, st = ssd.ssd_apply(p, _t(x[:, t:t + 1]), cfg, div={}, state=st)
            jy_t, jst = j_ssd.ssd_apply(jp, jnp.asarray(x[:, t:t + 1]), cfg, div={}, state=jst)
            _close(y_t, jy_t, 1e-4)
            ys.append(y_t)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_full.numpy(), rtol=2e-3, atol=2e-3)
    for key in ("h", "conv"):
        np.testing.assert_allclose(st[key].numpy(), st_full[key].numpy(), rtol=2e-3, atol=2e-3)


# -- the four models against repro ---------------------------------------------------------


def test_layer_flags_and_caches_follow_repro():
    jmodel, _, model, _ = _pair("zamba2-1.2b")
    assert model.layer_flags()["use_attn"] == [False, True, False, True]
    np.testing.assert_array_equal(np.asarray(jmodel.layer_flags()["use_attn"]),
                                  model.layer_flags()["use_attn"])
    full = LM(dataclasses.replace(model.cfg, n_layers=38, attn_every=6))
    assert [i for i, f in enumerate(full.layer_flags()["use_attn"]) if f] == [5, 11, 17, 23,
                                                                            29, 35]
    for arch in FAMILIES:
        jmodel, _, model, _ = _pair(arch)
        want = jax.tree.map(lambda s: (s.shape, str(s.dtype)), jmodel.cache_specs(2, 12),
                            is_leaf=lambda s: hasattr(s, "axes"))
        got = jax.tree.map(lambda s: (s.shape, str(s.dtype)), model.cache_specs(2, 12),
                           is_leaf=lambda s: hasattr(s, "axes"))
        assert got == want, arch
    assert isinstance(_pair("whisper-large-v3")[2], EncDec)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_prefill_and_decode_match_repro(arch, backend):
    model, params = _pair(arch)[2:]
    want_full, want_logits, jcache, want_steps = _repro_run(arch)
    toks, extra = _inputs(arch)
    with gemm_context(backend=backend, device="cpu") as ctx:
        full, logits, cache, steps = _run(model, params, toks, extra, steps=1, lib=torch)
    _close(full, want_full, 1e-4)
    _close(logits, want_logits, 1e-4)
    _close(steps[0], want_steps[0], 1e-4)
    # the prefill cache, leaf for leaf (zamba2: the marked layers' attention rows)
    fam = model.cfg.family
    assert set(cache) == set(jcache)
    if "ssm" in cache:
        for key in ("h", "conv"):
            _close(cache["ssm"][key].numpy(), jcache["ssm"][key], 1e-4)
    rows = [i for i, f in enumerate(model.layer_flags()["use_attn"]) if f] \
        if fam == "hybrid" else slice(None)
    for part in ("attn", "cross"):
        if part in cache:
            for key in "kv":
                _close(cache[part][key][rows].numpy(), jcache[part][key][rows], 1e-4)
    tags = {e.tag for e in ctx.log}
    assert "lm_head" in tags
    assert ({"ssm.in", "ssm.out"} <= tags) == (fam in ("ssm", "hybrid"))
    assert ({"xattn.k", "xattn.v"} <= tags) == (fam == "encdec")
    if fam == "encdec":
        assert {e.op.epilogue.activation for e in ctx.log if e.tag == "mlp.in"} == {"gelu"}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_chain_equals_forward(arch, backend):
    """Prefill of S0 tokens, then a decode step per token to S: each step's
    logits against ``forward``'s at that position (2e-3)."""
    model, params = _pair(arch)[2:]
    toks, extra = _inputs(arch)
    with gemm_context(backend=backend, device="cpu"):
        full, logits, _, steps = _run(model, params, toks, extra, steps=S - S0, lib=torch)
    np.testing.assert_allclose(logits[:, 0], full[:, S0 - 1], rtol=2e-3, atol=2e-3)
    for i, step in enumerate(steps):
        np.testing.assert_allclose(step, full[:, S0 + i], rtol=2e-3, atol=2e-3)


def test_vlm_patches_take_the_first_positions():
    """The image prompt's patches shift the text: the logits differ from a
    prompt without them (the planted fault of the card's image request)."""
    model, params = _pair("llava-next-34b")[2:]
    toks, patches = _inputs("llava-next-34b")
    with_img, _ = model.prefill(params, _t(toks).long(), patch_embeds=_t(patches))
    without, _ = model.prefill(params, _t(toks).long())
    assert (with_img - without).abs().max() > 1e-2
    x = model._embed(params, _t(toks).long(), _t(patches))
    p = model.cfg.n_patches
    torch.testing.assert_close(x[:, :p], _t(patches))
    torch.testing.assert_close(x[:, p:], params["embed"][_t(toks[:, :S - p]).long()])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", DECODER_ONLY)
def test_serve_engine_greedy_tokens_match_repro(arch, backend):
    """4 requests through 2 slots: each slot serves two requests in turn,
    so a reused slot must hold nothing of the one before (mamba2's state
    and conv tail are replaced at prefill)."""
    model, params = _pair(arch)[2:]
    eng = ServeEngine(model, params, ServeConfig(n_slots=2, max_seq=40, eos=-1),
                      backend=backend, device="cpu")
    for p in PROMPTS:
        eng.submit(p, max_new_tokens=6)
    done = {r.uid: r.out_tokens for r in eng.run()}
    assert len(done) == 4 and not eng.exhausted
    assert done == _repro_tokens(arch)


@pytest.mark.parametrize("backend", BACKENDS)
def test_encdec_greedy_tokens_match_repro(backend):
    model, params = _pair("whisper-large-v3")[2:]
    with gemm_context(backend=backend, device="cpu"):
        got = _encdec_greedy(model, params, torch)
    assert got == _repro_tokens("whisper-large-v3")


def test_mamba2_int8_rung_tokens_match_repro():
    jmodel, jparams, model, _ = _pair("mamba2-1.3b")
    jq, n, skipped = jmodel.quantize_weights(jparams, bits=8)
    params = params_from_jax(jax.tree.map(np.asarray, jq), device="cpu")
    assert n > 0 and all(isinstance(params["layers"]["ssm"][key], QuantizedTensor)
                         for key in ("w_in", "w_out"))
    with j_gemm_context(backend="xla"):
        jeng = JServeEngine(jmodel, jq, JServeConfig(n_slots=2, max_seq=40, eos=-1))
        for p in PROMPTS:
            jeng.submit(p, max_new_tokens=5)
        want = {r.uid: r.out_tokens for r in jeng.run()}
    eng = ServeEngine(model, params, ServeConfig(n_slots=2, max_seq=40, eos=-1),
                      backend="torch", device="cpu")
    for p in PROMPTS:
        eng.submit(p, max_new_tokens=5)
    assert {r.uid: r.out_tokens for r in eng.run()} == want
    assert {e.op.in_dtype for e in eng.selection_log if e.tag.startswith("ssm.")} == {
        "float32*int8"}


# -- the serve CLI ---------------------------------------------------------------------------


def test_serve_cli_mamba2_tokens_match_repro_cli(monkeypatch):
    """The serve CLI on reduced mamba2-1.3b on the CPU against ``repro``'s
    CLI with the same flags and ``repro``'s seeded weights (as
    ``tests/test_torch_archs.py`` does for gemma3): the same greedy
    tokens."""
    from repro.serve.engine import EngineCore as JEngineCore
    from repro_torch.serve.engine import EngineCore

    argv = ["--arch", "mamba2-1.3b", "--preset", "reduced", "--dtype", "float32", "--requests",
            "4", "--slots", "2", "--max-seq", "48", "--max-new-tokens", "5", "--seed", "0"]
    tokens = {}

    def recording(cls, side):
        run = cls.run

        def wrapped(self, *a, **kw):
            done = run(self, *a, **kw)
            tokens.setdefault(side, {}).update({r.uid: list(r.out_tokens) for r in done})
            return done
        monkeypatch.setattr(cls, "run", wrapped)

    def repro_weights(self, device=None, generator=None):
        return _pair("mamba2-1.3b")[3]

    recording(JEngineCore, "repro")
    recording(EngineCore, "port")
    monkeypatch.setattr(LM, "init_params", repro_weights)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    assert j_serve.main() == 0
    assert t_serve.main(argv + ["--device", "cpu"]) == 0
    assert len(tokens["port"]) == 4 and all(len(t) == 5 for t in tokens["port"].values())
    assert tokens["port"] == tokens["repro"]


def test_serve_cli_refuses_whisper_and_paged_ssm_as_repro(monkeypatch):
    for extra, exc in ((["--arch", "whisper-large-v3"], SystemExit),
                       (["--arch", "mamba2-1.3b", "--paged", "--max-seq", "32"], ValueError)):
        argv = ["--preset", "reduced", "--requests", "2"] + extra
        monkeypatch.setattr(sys, "argv", ["serve"] + argv)
        with pytest.raises(exc) as want:
            j_serve.main()
        with pytest.raises(exc) as got:
            t_serve.main(argv + ["--device", "cpu"])
        assert str(got.value) == str(want.value)
