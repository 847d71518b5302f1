"""The compiled decode step (``repro_torch.serve.graphs``) on the CPU.

* Every family's ``decode_step`` writes its cache in place: granite,
  olmoe, gemma3's ring caches, mamba2, zamba2, llava and the int8 KV cache,
  reduced, in f32. Over three steps from an empty cache (rows at unequal
  positions, gemma3's rings wrapping) each leaf keeps its storage and holds
  ``repro``'s new cache within 1e-4 x max|ref| (the int8 codes exactly);
  the paged engine's device step writes the new row into the pool's pages.
* The slot and paged engines through the step object give ``repro``'s
  engines' greedy tokens on weights carried across by ``params_from_jax``
  (granite, gemma3 and mamba2 reduced; the paged engine granite and
  gemma3), with ``step_mode`` "eager" and no capture on the CPU.
* With a capture stand-in (:class:`StandIn`, ``CudaGraphs``' part on the
  CPU: a capture runs the step's host side and leaves the cache as it found
  it; a replay runs the step with its launches listed, not counted): one
  capture per key and the eager tokens, a re-capture after ``hot_swap``,
  the paged keys bounded by the padded table widths, launches counted once
  per replay as the eager run counts them, a failing capture that raises
  (and raises again, never serving eagerly), and a stale token buffer that
  changes the tokens.
* ``step_mode``: "graph" for a CUDA device, "eager" on the CPU, under
  ``disable_graphs()`` and under a ranked plan.
* ``import repro_torch.serve.graphs`` leaves ``jax`` out of ``sys.modules``.
"""

import dataclasses
import functools
import math
import os
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.core.gemm import gemm_context as j_gemm_context
from repro.dist.sharding import materialize_tree
from repro.models import build_model as j_build_model
from repro.serve import PagedServeConfig as JPagedServeConfig
from repro.serve import PagedServeEngine as JPagedServeEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_reduced
from repro_torch.core.gemm import gemm_context
from repro_torch.dist.sharding import ShardingPlan, use_plan
from repro_torch.kernels import common
from repro_torch.launch.mesh import virtual_mesh
from repro_torch.models import build_model
from repro_torch.models import lm as lm_mod
from repro_torch.models.lm import params_from_jax
from repro_torch.serve import (
    DecodeStep,
    PagedServeConfig,
    PagedServeEngine,
    PageTable,
    ServeConfig,
    ServeEngine,
    disable_graphs,
    graphs,
    step_mode,
)

ROOT = Path(__file__).resolve().parents[1]
PROMPTS = [np.array(p, np.int32) for p in (list(range(3, 14)), [200, 1], list(range(100, 119)),
                                           [7, 7, 7, 9])]


@functools.lru_cache(maxsize=None)
def _pair(arch, **overrides):
    jcfg = dataclasses.replace(j_get_reduced(arch), dtype="float32", **overrides)
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32", **overrides)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jmodel = j_build_model(jcfg)
    jparams = materialize_tree(jmodel.param_specs(), jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, build_model(cfg), params


def _leaves(tree, prefix=""):
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            yield from _leaves(leaf, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", leaf


# -- in place -------------------------------------------------------------------------------

IN_PLACE = [("granite-8b", {}), ("olmoe-1b-7b", {}), ("gemma3-27b", {"window_cache": True}),
            ("mamba2-1.3b", {}), ("zamba2-1.2b", {}), ("llava-next-34b", {}),
            ("granite-8b", {"kv_cache_dtype": "int8"})]


@pytest.mark.parametrize("arch,overrides", IN_PLACE,
                         ids=[a + "".join(f"-{v}" for v in o.values()) for a, o in IN_PLACE])
def test_decode_step_writes_the_cache_in_place(arch, overrides):
    jmodel, jparams, model, params = _pair(arch, **overrides)
    if overrides.get("window_cache"):
        assert model._ring_cache
    b, max_seq = 2, 16
    jcache = jmodel.init_cache(b, max_seq)
    cache = model.init_cache(b, max_seq, device="cpu")
    ptrs = {name: leaf.data_ptr() for name, leaf in _leaves(cache)}
    rng = np.random.default_rng(1)
    pos = np.array([0, 9], np.int64)  # gemma3's rings (window 8) wrap on row 1
    for _ in range(3):
        toks = rng.integers(1, model.cfg.vocab_size, (b, 1))
        with j_gemm_context(backend="xla"):
            jlogits, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(toks, jnp.int32),
                                                 jnp.asarray(pos, jnp.int32))
        logits, back = model.decode_step(params, cache, torch.as_tensor(toks),
                                         torch.as_tensor(pos))
        assert all(x is y for (_, x), (_, y) in zip(_leaves(back), _leaves(cache)))
        ref = np.asarray(jlogits)
        assert np.abs(logits.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
        wants = dict(_leaves(jax.tree.map(np.asarray, jcache)))
        assert sorted(wants) == sorted(ptrs)
        for name, leaf in _leaves(cache):
            want = wants[name]
            assert leaf.data_ptr() == ptrs[name], name
            got = leaf.numpy()
            if got.dtype == np.int8:
                np.testing.assert_array_equal(got, want, err_msg=name)
            else:
                assert np.abs(got - want).max() <= 1e-4 * max(np.abs(want).max(), 1e-6), name
        pos = pos + 1


def test_paged_device_step_writes_the_pool_in_place():
    """The paged engine's device step on its static buffers: the pool keeps
    its storage, and each real row's new K/V row lands in its page at its
    offset as the dense cache's step writes it."""
    model, params = _pair("granite-8b")[2:]
    eng = PagedServeEngine(model, params, PagedServeConfig(page_size=4, max_pages=12,
                                                           max_active=3, max_seq=24, eos=-1),
                           device="cpu")
    dense = ServeEngine(model, params, ServeConfig(n_slots=3, max_seq=24, eos=-1), device="cpu")
    for e in (eng, dense):
        for p in PROMPTS[:2]:
            e.submit(p, max_new_tokens=4)
    eng._admit()
    while eng._prefill_tick():
        pass
    dense._admit()
    ptrs = {name: leaf.data_ptr() for name, leaf in _leaves(eng.kv.pool)}
    reqs = eng._decode_candidates()
    tokens = np.array([[r.out_tokens[-1]] for r in reqs] + [[0]], np.int64)
    pos = np.array([r.pos for r in reqs] + [0], np.int64)
    tables = [r.table for r in reqs] + [PageTable()]
    got = eng._paged_decode(eng.kv.padded_tables(tables), tokens, pos, len(reqs))
    want = dense.decode((3, 24), tokens=tokens, pos=dense.pos)
    assert (got[:2] - want[:2]).abs().max() <= 1e-4 * want.abs().max()
    for name, leaf in _leaves(eng.kv.pool):
        assert leaf.data_ptr() == ptrs[name]
    for i, r in enumerate(reqs):
        page, off = r.table.pages[r.pos // 4], r.pos % 4
        for key in ("k", "v"):
            row = eng.kv.pool["attn"][key][:, page, off]
            ref = dense.cache["attn"][key][:, i, r.pos]
            assert ref.abs().max() > 0 and (row - ref).abs().max() <= 1e-4 * ref.abs().max()


# -- the engines against repro's ------------------------------------------------------------------


def _serve(eng, n=4, new=5):
    for p in PROMPTS[:n]:
        eng.submit(p, max_new_tokens=new)
    done = eng.run()
    assert not eng.exhausted
    return {r.uid: list(r.out_tokens) for r in done}


@functools.lru_cache(maxsize=None)
def _repro_tokens(arch, paged):
    jmodel, jparams = _pair(arch)[:2]
    with j_gemm_context(backend="xla"):
        if paged:
            jeng = JPagedServeEngine(jmodel, jparams, JPagedServeConfig(
                page_size=4, max_pages=24, max_active=3, max_seq=40, eos=-1))
        else:
            jeng = JServeEngine(jmodel, jparams, JServeConfig(n_slots=2, max_seq=40, eos=-1))
        return _serve(jeng)


def _engine(arch, paged, **kw):
    model, params = _pair(arch)[2:]
    if paged:
        return PagedServeEngine(model, params, PagedServeConfig(
            page_size=4, max_pages=24, max_active=3, max_seq=40, eos=-1), device="cpu", **kw)
    return ServeEngine(model, params, ServeConfig(n_slots=2, max_seq=40, eos=-1), device="cpu",
                       **kw)


@pytest.mark.parametrize("arch,paged", [("granite-8b", False), ("gemma3-27b", False),
                                        ("mamba2-1.3b", False), ("granite-8b", True),
                                        ("gemma3-27b", True)])
def test_engines_through_the_step_match_repro(arch, paged):
    eng = _engine(arch, paged)
    assert eng.step_mode == "eager" and isinstance(eng.decode, DecodeStep)
    assert _serve(eng) == _repro_tokens(arch, paged)
    assert eng.decode.captured == [] and eng.decode.replays == 0
    assert eng.timing["decode_steps"] > 0


# -- the capture stand-in -------------------------------------------------------------------------


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _restore(tree, saved):
    for k, v in tree.items():
        if isinstance(v, dict):
            _restore(v, saved[k])
        else:
            v.copy_(saved[k])


class StandIn:
    """``CudaGraphs``' part on the CPU for one engine. A capture runs the
    step's host side (dispatch, selection log, the launch list) and leaves
    the engine's cache as it found it, as a capture runs nothing on the
    device; a replay runs the step again under the engine's selector with
    its launches listed, not counted, and writes the capture's output."""

    captures = 0
    fail = False

    def __init__(self, engine):
        self.engine = engine

    @contextmanager
    def warmup(self):
        yield

    def _state(self):
        eng = self.engine
        return eng.kv.pool if isinstance(eng, PagedServeEngine) else eng.cache

    def capture(self, fn):
        if StandIn.fail:
            raise RuntimeError("capture failed")
        StandIn.captures += 1
        saved = _clone(self._state())
        out = fn()
        _restore(self._state(), saved)
        eng = self.engine

        def replay():
            with gemm_context(selector=eng.selector, backend=eng.backend, device="cpu"), \
                    common.capturing():
                got = fn()
            return out.copy_(got)

        return replay, 0


@pytest.fixture
def stand_in(monkeypatch):
    """Graph mode on the CPU, through :class:`StandIn`; yields a function
    that builds an engine."""
    monkeypatch.setattr(graphs, "step_mode",
                        lambda device: "eager" if graphs._disabled else "graph")
    monkeypatch.setattr(StandIn, "captures", 0)
    monkeypatch.setattr(StandIn, "fail", False)

    def make(arch="granite-8b", paged=False, **kw):
        eng = _engine(arch, paged, **kw)
        monkeypatch.setattr(graphs, "CudaGraphs", lambda device: StandIn(eng))
        return eng

    yield make


def _eager_tokens(arch, paged):
    with disable_graphs():
        eng = _engine(arch, paged)
        assert eng.step_mode == "eager"
        return _serve(eng)


@pytest.mark.parametrize("paged", [False, True])
def test_one_capture_per_key_replays_the_eager_tokens(stand_in, paged):
    eng = stand_in(paged=paged)
    assert eng.step_mode == "graph"
    tokens = _serve(eng)
    step = eng.decode
    keys = [c.key for c in step.captured]
    assert len(keys) == len(set(keys)) == StandIn.captures >= 1
    assert step.replays == eng.timing["decode_steps"] - len(keys) > 0
    assert all(c.selections and c.replay is not None for c in step.captured)
    assert tokens == _eager_tokens("granite-8b", paged) == _repro_tokens("granite-8b", paged)


def test_hot_swap_captures_anew(stand_in):
    eng = stand_in()
    for p in PROMPTS[:2]:
        eng.submit(p, max_new_tokens=8)
    for _ in range(3):
        eng.step()
    step = eng.decode
    assert len(step.captured) == 1 and step.replays == 2
    eng.selector.hot_swap()
    eng.step()
    assert len(step.captured) == 2 and step.captured[0].replay is None
    assert step.captured[1].key == (step.captured[0].key[0], eng.selector.swaps)
    eng.step()
    assert len(step.captured) == 2 and step.captured[1].replays == 1
    done = {r.uid: list(r.out_tokens) for r in eng.run()}
    with disable_graphs():
        assert done == _serve(_engine("granite-8b", False), n=2, new=8)


def test_paged_keys_stay_within_the_padded_widths(stand_in):
    eng = stand_in(paged=True)
    for p in PROMPTS:
        eng.submit(p, max_new_tokens=14)
    eng.run()
    widths = {c.key[0] for c in eng.decode.captured}
    cap = math.ceil(math.log2(40 / 4)) + 1
    assert len(eng.decode.captured) == len(widths) <= cap and len(widths) >= 2
    assert all(w & (w - 1) == 0 for w in widths)  # powers of two


@pytest.mark.parametrize("paged", [False, True])
def test_launches_count_once_per_replay(stand_in, monkeypatch, paged):
    """A wrapper's launch (here the head's GEMM, made to record one) counts
    in ``LAUNCHES`` and in an open ``count_launches`` log once per replay:
    the graph run counts what the eager run counts."""
    real = lm_mod.gemm

    def counted(*a, **kw):
        common.record_launch("dp_gemm_region")
        return real(*a, **kw)

    monkeypatch.setattr(lm_mod, "gemm", counted)
    counts = {}
    for mode in ("graph", "eager"):
        common.reset_launch_counts()
        with common.count_launches() as log:
            if mode == "graph":
                eng = stand_in(paged=paged)
                _serve(eng)
            else:
                with disable_graphs():
                    eng = _engine("granite-8b", paged)
                    _serve(eng)
        counts[mode] = (common.LAUNCHES["dp_gemm_region"], len(log), eng.timing["decode_steps"])
        if mode == "graph":
            step = eng.decode
            assert all(c.launches == ["dp_gemm_region"] for c in step.captured)
            assert step.replays > 0
    assert counts["graph"] == counts["eager"]
    assert counts["graph"][0] == counts["graph"][1] > counts["graph"][2]


def test_a_failing_capture_raises_and_never_runs_eagerly(stand_in):
    StandIn.fail = True
    eng = stand_in()
    eng.submit(PROMPTS[0], max_new_tokens=4)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capture failed"):
            eng.step()
        assert eng.step_mode == "graph" and eng.decode.captured == []
        assert eng.timing["decode_steps"] == 0
        assert len(eng.slot_req[0].out_tokens) == 1  # the prefill's token only


def test_a_stale_token_buffer_changes_the_tokens(stand_in):
    eng = stand_in()
    step = eng.decode

    def stale(name, buf, a):  # a replay that skips refreshing the token buffer
        if not (name == "tokens" and step.captured):
            DecodeStep.copy_in(step, name, buf, a)

    step.copy_in = stale
    assert _serve(eng) != _eager_tokens("granite-8b", False)


# -- the mode and the imports ---------------------------------------------------------------------


def test_step_mode_is_eager_on_the_cpu_and_across_ranks():
    assert step_mode(torch.device("cuda")) == "graph"
    assert step_mode("cpu") == "eager"
    with disable_graphs():
        assert step_mode("cuda") == "eager"
        with disable_graphs():
            pass
        assert step_mode("cuda") == "eager"
    assert step_mode("cuda") == "graph"
    model, params = _pair("granite-8b")[2:]
    with use_plan(ShardingPlan(virtual_mesh((1, 2)))):
        assert step_mode("cuda") == "eager"
        shards = model.init_params(device="cpu")
        eng = ServeEngine(model, shards, ServeConfig(n_slots=2, max_seq=8), device="cpu")
        assert eng.step_mode == "eager"
    assert ServeEngine(model, params, ServeConfig(n_slots=2, max_seq=8),
                       device="cpu").step_mode == "eager"


def test_graphs_module_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import sys, repro_torch.serve.graphs, repro_torch.serve; "
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) for m in sys.modules), "
            "sorted(m for m in sys.modules if m.startswith(('jax', 'repro.')))")
    subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=120)
