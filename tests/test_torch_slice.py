"""The served slice end to end: reduced granite-8b in f32, with ``repro``'s
parameters carried into the port by ``params_from_jax``.

* Prefill logits agree with ``repro``'s ``LM.prefill`` (xla backend) within
  1e-4 x max|logit|: both sides compute in f32, in different summation
  orders, through about a dozen chained ops per layer.
* The port's ``ServeEngine`` emits the SAME greedy tokens as ``repro``'s
  for three requests — through the ``torch`` backend, and through the
  ``cuda`` backend's kernel composition (the kernels' plain versions on CPU
  tensors).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.core.gemm import gemm_context as j_gemm_context
from repro.dist.sharding import materialize_tree
from repro.models.lm import LM as JLM
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_reduced
from repro_torch.core.gemm import gemm_context
from repro_torch.models.lm import LM, params_from_jax
from repro_torch.serve.engine import ServeConfig, ServeEngine

PROMPTS = [np.array(p, np.int32) for p in ([5, 17, 3, 99, 42, 7], [200, 1, 64], list(range(30, 53)))]


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(j_get_reduced("granite-8b"), dtype="float32")
    cfg = dataclasses.replace(get_reduced("granite-8b"), dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jmodel = JLM(jcfg)
    jparams = materialize_tree(jmodel.param_specs(), jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, LM(cfg), params


def test_params_carry_across_exactly(pair):
    jmodel, jparams, model, params = pair
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)

    def count(tree):
        return sum(count(v) for v in tree.values()) if isinstance(tree, dict) else 1

    assert count(params) == count(model.param_specs()) == len(flat_j)
    for path, leaf in flat_j:
        node = params
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_prefill_logits_match_repro(pair, backend):
    jmodel, jparams, model, params = pair
    for prompt in PROMPTS:
        want, jcache = jmodel.prefill(jparams, jax.numpy.asarray(prompt)[None], max_seq=48)
        with gemm_context(backend=backend, device="cpu"):
            got, cache = model.prefill(params, torch.from_numpy(prompt).long()[None], max_seq=48)
        want = np.asarray(want)
        tol = 1e-4 * np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
        np.testing.assert_allclose(
            cache["attn"]["k"].numpy(), np.asarray(jcache["attn"]["k"]), rtol=0, atol=1e-4
        )


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_serve_engine_greedy_tokens_identical(pair, backend):
    jmodel, jparams, model, params = pair
    jeng = JServeEngine(jmodel, jparams, JServeConfig(n_slots=2, max_seq=48, eos=-1))
    eng = ServeEngine(model, params, ServeConfig(n_slots=2, max_seq=48, eos=-1),
                      backend=backend, device="cpu")
    with j_gemm_context(backend="xla"):
        for p in PROMPTS:
            jeng.submit(p, max_new_tokens=6)
        jdone = {r.uid: r.out_tokens for r in jeng.run()}
    for p in PROMPTS:
        eng.submit(p, max_new_tokens=6)
    done = {r.uid: r.out_tokens for r in eng.run()}
    assert len(done) == 3 and not eng.exhausted
    assert done == jdone
    tags = {e.tag for e in eng.selection_log}
    assert tags == {"attn.q", "attn.k", "attn.v", "attn.o", "mlp.gate", "mlp.in", "mlp.out",
                    "lm_head"}
    assert eng.timing["decode_steps"] > 0 and eng.timing["prefill_tokens"] == sum(map(len, PROMPTS))
