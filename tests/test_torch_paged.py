"""Paged KV serving of the port against ``repro``'s, on the CPU: reduced
granite-8b and olmoe-1b-7b in f32 with ``repro``'s parameters carried
across by ``params_from_jax``.

* The page pool: the allocator's page ids, FIFO recycling, ``try_alloc``'s
  atomicity, its errors and ``occupancy()`` equal ``repro``'s;
  ``gather_view``, ``rows_at``, ``scatter_rows``, ``scatter_prefill`` and
  ``padded_tables`` give ``repro``'s values exactly on the same pool, with
  the model-dtype cache and with the int8 cache (int8 K/V and f32 scales).
* ``LM.prefill_chunk``: logits and cache rows against ``repro``'s within
  1e-5 x max|ref| (f32 sums in other orders), the int8 cache's codes byte
  for byte; chained chunks against one ``prefill`` within the same limit
  (with the model-dtype cache: under the int8 one a chunk attends over the
  quantized prefix, where one prefill attends over the exact rows).
* ``PagedServeEngine``, whole-prompt and ``prefill_chunk=5``: the greedy
  tokens, every request's step stamps and ``metrics()`` equal ``repro``'s,
  and the tokens equal the port's dense ``ServeEngine``'s; so do the
  stall-then-recover, gridlock-truncation, admission-rejection and
  never-admissible cases of ``tests/test_serve_paged.py``.
* Replay: ``replay_arrivals`` equals ``repro``'s, and ``replay_stream``
  finishes the same requests with the same tokens and step stamps.
* The serve CLI on the CPU with ``--paged --prefill-chunk --replay``, and
  the ``100m`` preset field by field against ``repro``'s.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.dist.sharding import materialize_tree
from repro.launch import serve as j_serve
from repro.launch.train import preset_config as j_preset_config
from repro.models.lm import LM as JLM
from repro.serve import AdmissionError as JAdmissionError
from repro.serve import PagedKVCache as JPagedKVCache
from repro.serve import PagedServeConfig as JPagedServeConfig
from repro.serve import PagedServeEngine as JPagedServeEngine
from repro.serve import PageExhausted as JPageExhausted
from repro.serve import PageTable as JPageTable
from repro_torch.configs import get_reduced, list_archs, preset_config
from repro_torch.launch import serve as t_serve
from repro_torch.models.lm import LM, params_from_jax
from repro_torch.serve import (
    AdmissionError,
    PagedKVCache,
    PagedServeConfig,
    PagedServeEngine,
    PageExhausted,
    PageTable,
    ServeConfig,
    ServeEngine,
)

ARCHS = ["granite-8b", "olmoe-1b-7b"]


@functools.lru_cache(maxsize=None)
def _pair(arch, kv_cache_dtype="model"):
    jcfg = dataclasses.replace(j_get_reduced(arch), dtype="float32",
                               kv_cache_dtype=kv_cache_dtype)
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32", kv_cache_dtype=kv_cache_dtype)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jmodel = JLM(jcfg)
    jparams = materialize_tree(jmodel.param_specs(), jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, LM(cfg), params


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(request.param)


@pytest.fixture(scope="module")
def granite():
    return _pair("granite-8b")


def mixed_prompts(vocab, n=6, lo=4, hi=13, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=int(rng.integers(lo, hi))).astype(np.int32)
            for _ in range(n)]


# -- the page pool ---------------------------------------------------------------


def test_allocator_matches_repro(granite):
    jmodel, _, model, _ = granite
    jkv = JPagedKVCache(jmodel, page_size=4, n_pages=6)
    kv = PagedKVCache(model, page_size=4, n_pages=6, device="cpu")

    def both(op, *a):
        return getattr(jkv, op)(*a), getattr(kv, op)(*a)

    for op, args in [("try_alloc", (2,)), ("alloc", (3,)), ("try_alloc", (2,)),
                     ("pages_for", (9,)), ("pages_for", (0,)), ("occupancy", ())]:
        j, t = both(op, *args)
        assert j == t, op
    first = [0, 1]
    jkv.free(first), kv.free(first)  # FIFO: freed pages go to the back
    for n in (1, 1, 1):
        j, t = both("try_alloc", n)
        assert j == t
    assert jkv.try_alloc(5) is None and kv.try_alloc(5) is None  # atomic: nothing taken
    assert jkv.occupancy() == kv.occupancy()
    with pytest.raises(JPageExhausted):
        jkv.alloc(5)
    with pytest.raises(PageExhausted):
        kv.alloc(5)
    for e in (jkv, kv):
        for bad in ([6], [-1]):
            with pytest.raises(ValueError, match="invalid"):
                e.free(bad)
        e.free([5])
        with pytest.raises(ValueError, match="double free"):
            e.free([5])
    assert list(jkv._free) == list(kv._free) == [5]
    assert jkv.occupancy() == kv.occupancy() and jkv.peak_used == kv.peak_used == 6
    with pytest.raises(ValueError, match="geometry"):
        PagedKVCache(model, page_size=0, n_pages=4, device="cpu")


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_pool_adapters_match_repro(kv_dtype):
    jmodel, _, model, _ = _pair("granite-8b", kv_dtype)
    ps, n_pages = 4, 7
    jkv = JPagedKVCache(jmodel, page_size=ps, n_pages=n_pages)
    kv = PagedKVCache(model, page_size=ps, n_pages=n_pages, device="cpu")
    rng = np.random.default_rng(1)

    def draw(shape, dtype):
        if dtype == np.int8:
            return rng.integers(-127, 128, size=shape).astype(np.int8)
        return rng.normal(size=shape).astype(np.float32)

    pool_np = {key: draw(tuple(a.shape), np.dtype(a.dtype).type)
               for key, a in jkv.pool["attn"].items()}
    assert {key: a.shape for key, a in kv.pool["attn"].items()} == {
        key: a.shape for key, a in pool_np.items()}
    assert set(pool_np) == ({"k", "v"} if kv_dtype == "model" else
                            {"k", "v", "k_scale", "v_scale"})
    jpool = {"attn": {key: jnp.asarray(a) for key, a in pool_np.items()}}
    kv.pool = {"attn": {key: torch.from_numpy(a.copy()) for key, a in pool_np.items()}}

    def same(jtree, ttree):
        assert set(jtree["attn"]) == set(ttree["attn"])
        for key, a in jtree["attn"].items():
            assert ttree["attn"][key].numpy().tobytes() == np.asarray(a).tobytes(), key
            assert tuple(ttree["attn"][key].shape) == a.shape, key

    tables = [JPageTable([3, 0, 5], 9), JPageTable([6], 2), JPageTable()]
    ttables = [PageTable(list(t.pages), t.length) for t in tables]
    pages_2d = kv.padded_tables(ttables)
    np.testing.assert_array_equal(pages_2d, np.asarray(jkv.padded_tables(tables)))
    assert pages_2d.shape == (3, 4) and (pages_2d[2] == n_pages).all()
    assert kv.padded_tables([], min_pages=3).shape == (0, 4)
    jview = jkv.gather_view(jpool, jnp.asarray(pages_2d))
    view = kv.gather_view(kv.pool, pages_2d)
    same(jview, view)
    pos = np.array([9, 2, 0], np.int32)
    same(jkv.rows_at(jview, jnp.asarray(pos)), kv.rows_at(view, pos))
    # one row per sequence into its page; the padded row into scratch
    page_ids = pages_2d[np.arange(3), pos // ps]
    rows = {key: draw((a.shape[0], 3, *a.shape[3:]), np.dtype(a.dtype).type)
            for key, a in pool_np.items()}
    jpool = jkv.scatter_rows(jpool, jnp.asarray(page_ids), jnp.asarray(pos % ps),
                             {"attn": {key: jnp.asarray(r) for key, r in rows.items()}})
    kv.scatter_rows(kv.pool, page_ids, pos % ps,
                    {"attn": {key: torch.from_numpy(r) for key, r in rows.items()}})
    same(jpool, kv.pool)
    pages = [1, 4]
    fresh = {key: draw((a.shape[0], 1, len(pages) * ps, *a.shape[3:]), np.dtype(a.dtype).type)
             for key, a in pool_np.items()}
    jpool = jkv.scatter_prefill(jpool, jnp.asarray(pages, jnp.int32),
                                {"attn": {key: jnp.asarray(f) for key, f in fresh.items()}})
    kv.scatter_prefill(kv.pool, pages, {"attn": {key: torch.from_numpy(f)
                                                 for key, f in fresh.items()}})
    same(jpool, kv.pool)


# -- chunked prefill ---------------------------------------------------------------


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max(), (what, err, np.abs(want).max())


@pytest.mark.parametrize("arch,kv_dtype", [("granite-8b", "model"), ("olmoe-1b-7b", "model"),
                                           ("granite-8b", "int8")])
def test_prefill_chunk_matches_repro(arch, kv_dtype):
    jmodel, jparams, model, params = _pair(arch, kv_dtype)
    prompt = np.array([5, 17, 3, 99, 42, 7, 11, 2, 8, 61, 30, 12, 4], np.int32)
    max_seq = 16
    jlogits, jcache = jmodel.prefill(jparams, jnp.asarray(prompt[None, :5]), max_seq=max_seq)
    logits, cache = model.prefill(params, torch.as_tensor(prompt[None, :5]), max_seq=max_seq)
    _close(logits, jlogits, "first chunk")
    for start, end in ((5, 10), (10, 13)):
        jlogits, jcache = jmodel.prefill_chunk(
            jparams, jcache, jnp.asarray(prompt[None, start:end]), jnp.asarray([start]))
        logits, cache = model.prefill_chunk(params, cache, torch.as_tensor(prompt[None, start:end]),
                                            torch.tensor([start]))
        _close(logits, jlogits, f"chunk {start}")
    for key, leaf in cache["attn"].items():
        want = np.asarray(jcache["attn"][key])
        if leaf.dtype == torch.int8:
            # codes: byte for byte where the rows were written
            np.testing.assert_array_equal(leaf[:, :, :13].numpy(), want[:, :, :13])
        elif key.endswith("_scale"):
            np.testing.assert_allclose(leaf[:, :, :13].numpy(), want[:, :, :13], rtol=1e-6)
        else:
            _close(leaf[:, :, :13], want[:, :, :13], key)
    if kv_dtype == "int8":
        return  # a chunk attends over the quantized prefix, one prefill over exact rows
    # chained chunks are the incremental prefill: the whole prompt at once
    jwhole, _ = jmodel.prefill(jparams, jnp.asarray(prompt[None]), max_seq=max_seq)
    whole, _ = model.prefill(params, torch.as_tensor(prompt[None]), max_seq=max_seq)
    _close(logits, jwhole, "chained vs repro's prefill")
    _close(logits, whole.numpy(), "chained vs the port's prefill")


def test_prefill_chunk_refusals(granite):
    model = granite[2]
    windowed = LM.__new__(LM)
    windowed.cfg = dataclasses.replace(model.cfg, window_cache=True)
    with pytest.raises(ValueError, match="uniform decode cache"):
        windowed.prefill_chunk(None, None, torch.zeros(1, 2, dtype=torch.long), torch.tensor([0]))
    ssm = LM.__new__(LM)
    ssm.cfg = dataclasses.replace(model.cfg, family="ssm")
    with pytest.raises(ValueError, match="attention-cache families"):
        ssm.prefill_chunk(None, None, torch.zeros(1, 2, dtype=torch.long), torch.tensor([0]))
    with pytest.raises(ValueError, match="attention-cache families"):
        PagedKVCache(ssm, page_size=4, n_pages=4, device="cpu")


# -- the engine ------------------------------------------------------------------


def _stamps(done):
    return {r.uid: (list(r.out_tokens), r.submit_step, r.first_token_step, r.done_step,
                    r.truncated) for r in done}


def run_both(pair, cfg, prompts, max_new, max_steps=10_000):
    """The same scenario on ``repro``'s engine (xla backend) and the port's
    (torch backend); returns both engines and their finished requests."""
    jmodel, jparams, model, params = pair
    jeng = JPagedServeEngine(jmodel, jparams, JPagedServeConfig(**cfg), backend="xla")
    eng = PagedServeEngine(model, params, PagedServeConfig(**cfg), device="cpu")
    for p in prompts:
        jeng.submit(p, max_new_tokens=max_new)
        eng.submit(p, max_new_tokens=max_new)
    return jeng, eng, _stamps(jeng.run(max_steps)), _stamps(eng.run(max_steps))


@pytest.mark.parametrize("chunk", [0, 5])
def test_paged_engine_matches_repro_and_dense(pair, chunk):
    model, params = pair[2], pair[3]
    prompts = (mixed_prompts(model.cfg.vocab_size) if chunk == 0 else
               mixed_prompts(model.cfg.vocab_size, n=4, lo=11, hi=21, seed=3))
    cfg = dict(page_size=8, max_pages=32, max_active=4, max_seq=64, eos=-1, prefill_chunk=chunk)
    jeng, eng, jdone, done = run_both(pair, cfg, prompts, max_new=6)
    assert len(done) == len(prompts) and done == jdone
    assert eng.metrics() == jeng.metrics()
    assert eng.kv.used_pages == 0  # every retirement returned its pages
    dense = ServeEngine(model, params, ServeConfig(n_slots=4, max_seq=64, eos=-1), device="cpu")
    for p in prompts:
        dense.submit(p, max_new_tokens=6)
    assert {r.uid: r.out_tokens for r in dense.run()} == {u: d[0] for u, d in done.items()}
    assert eng.timing["decode_steps"] > 0 and eng.timing["prefill_tokens"] == sum(
        len(p) for p in prompts)


def test_stall_then_recover_matches_repro(granite):
    cfg = dict(page_size=4, max_pages=2, max_active=2, max_seq=12, watermark=0.0, eos=-1)
    prompts = [np.array([3, 1], np.int32), np.array([2, 7, 5], np.int32)]
    jeng = JPagedServeEngine(granite[0], granite[1], JPagedServeConfig(**cfg), backend="xla")
    eng = PagedServeEngine(granite[2], granite[3], PagedServeConfig(**cfg), device="cpu")
    for e in (jeng, eng):
        e.submit(prompts[0], max_new_tokens=3)
        e.submit(prompts[1], max_new_tokens=6)
    jdone, done = _stamps(jeng.run()), _stamps(eng.run())
    assert done == jdone and eng.metrics() == jeng.metrics()
    assert len(done[2][0]) == 6 and not done[2][4]  # full budget despite the stall
    assert eng.stall_events >= 1 and eng.truncated == 0
    assert eng.kv.free_pages == eng.kv.n_pages


def test_gridlock_truncation_matches_repro(granite):
    cfg = dict(page_size=4, max_pages=2, max_active=2, max_seq=16, watermark=0.0, eos=-1)
    prompts = [np.arange(1, 5, dtype=np.int32)] * 2
    jeng, eng, jdone, done = run_both(granite, cfg, prompts, max_new=12, max_steps=200)
    assert done == jdone and eng.metrics() == jeng.metrics()
    assert not eng.exhausted and eng.truncated >= 1
    assert done[1][4]  # the oldest was the victim
    assert all(len(d[0]) >= 1 for d in done.values())


def test_admission_rejection_then_retry_matches_repro(granite):
    cfg = dict(page_size=8, max_pages=16, max_active=2, max_seq=32, max_queue=1, eos=-1)
    jeng = JPagedServeEngine(granite[0], granite[1], JPagedServeConfig(**cfg), backend="xla")
    eng = PagedServeEngine(granite[2], granite[3], PagedServeConfig(**cfg), device="cpu")
    prompt = np.array([1, 2, 3], np.int32)
    for e, err in ((jeng, JAdmissionError), (eng, AdmissionError)):
        e.submit(prompt, max_new_tokens=3)
        with pytest.raises(err):
            e.submit(prompt, max_new_tokens=3)
        assert e.rejected == 1
        e.step()  # the scheduler admits the queue head, freeing queue depth
        assert e.submit(prompt, max_new_tokens=3) == 2
    jdone, done = _stamps(jeng.run()), _stamps(eng.run())
    assert done == jdone and eng.metrics() == jeng.metrics()
    assert set(done) == {1, 2} and all(len(d[0]) == 3 for d in done.values())


def test_never_admissible_and_empty_prompts_refused(granite):
    eng = PagedServeEngine(granite[2], granite[3],
                           PagedServeConfig(page_size=4, max_pages=4, max_seq=64, eos=-1),
                           device="cpu")
    with pytest.raises(ValueError, match="watermark reserve"):
        eng.submit(np.arange(1, 17, dtype=np.int32))  # 16 tokens = 4 pages
    assert eng.rejected == 0  # a ValueError is not the backpressure counter
    with pytest.raises(ValueError, match="empty"):
        eng.submit(np.array([], np.int32))
    with pytest.raises(ValueError, match="max_active"):
        PagedServeEngine(granite[2], granite[3], PagedServeConfig(max_active=0), device="cpu")


# -- replay ----------------------------------------------------------------------


@pytest.mark.parametrize("pattern", ["poisson", "bursty"])
def test_replay_arrivals_match_repro(pattern):
    for seed in (0, 1, 7):
        for rate in (0.25, 1.0, 3.0):
            for n in (1, 9, 40):
                assert t_serve.replay_arrivals(n, pattern, rate, seed) == (
                    j_serve.replay_arrivals(n, pattern, rate, seed))


def test_replay_stream_matches_repro(granite):
    jmodel, jparams, model, params = granite
    prompts = mixed_prompts(model.cfg.vocab_size, n=5, lo=5, hi=14, seed=2)
    cfg = dict(page_size=8, max_pages=12, max_active=2, max_seq=32, max_queue=2,
               prefill_chunk=4, eos=-1)
    jeng = JPagedServeEngine(jmodel, jparams, JPagedServeConfig(**cfg), backend="xla")
    eng = PagedServeEngine(model, params, PagedServeConfig(**cfg), device="cpu")
    kw = dict(pattern="bursty", rate=2.0, seed=3, max_new=4, temperature=0.0)
    jdone = _stamps(j_serve.replay_stream(jeng, prompts, **kw))
    done = _stamps(t_serve.replay_stream(eng, prompts, **kw))
    assert len(done) == 5 and done == jdone
    assert eng.metrics() == jeng.metrics() and eng.rejected > 0


# -- the CLI ---------------------------------------------------------------------


def test_serve_cli_paged_chunked_replay_on_cpu(tmp_path):
    import json

    summary = tmp_path / "s.json"
    argv = ["--arch", "granite-8b", "--device", "cpu", "--preset", "reduced", "--paged",
            "--prefill-chunk", "16", "--replay", "poisson", "--requests", "5",
            "--max-new-tokens", "4", "--max-seq", "96", "--summary-json", str(summary)]
    assert t_serve.main(argv) == 0
    run = json.loads(summary.read_text())
    assert run["completed"] == 5 and run["tokens"] == 20
    (worker,) = run["workers"]
    assert worker["pool"]["n_pages"] == 4 * 96 // 16  # the equal-memory pool
    assert worker["pool"]["admitted"] == 5 and worker["pool"]["used_pages"] == 0
    assert worker["slo_steps"]["latency_p50"] >= worker["slo_steps"]["ttft_p50"] >= 0


def test_serve_cli_refuses_bad_fleet_flags():
    base = ["--arch", "granite-8b", "--device", "cpu"]
    for extra, match in ((["--workers", "0"], "--workers"), (["--merge-journals"], "--journal"),
                         (["--gossip-every", "-1"], "--gossip-every"),
                         (["--gossip-every", "2"], "--journal")):
        with pytest.raises(SystemExit, match=match):
            t_serve.main(base + extra)


@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("preset", ["100m", "reduced", "full"])
def test_preset_config_matches_repro(arch, preset):
    assert dataclasses.asdict(preset_config(arch, preset)) == dataclasses.asdict(
        j_preset_config(arch, preset))
    with pytest.raises(ValueError, match="unknown preset"):
        preset_config(arch, "1b")
