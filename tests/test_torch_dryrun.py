"""The port's dry run against the JAX package's traced steps, on the CPU.

* granite-8b and olmoe-1b-7b at full width cut to 2 layers, at
  ``decode_32k`` and ``train_4k`` on the single-pod mesh: the divisor table
  equals ``repro``'s (``train_gemm_div`` + the tokens' applied divisor), and
  the dispatch keys (``tag:local_mnk``) the port's meta trace logs equal
  those ``repro`` logs under ``gemm_context`` in ``jax.eval_shape`` of the
  same step (no plan installed there); under one machine and tile set given
  to both selectors, the selections (policy, tile, grid size) are equal too.
* The FLOP identity (the dispatch's share of ``FlopCounterMode``'s count is
  ``2 G M N K`` over the log) and the per-device argument bytes, against a
  count by hand of granite-8b's ``decode_32k`` cell.
* ``python -m repro_torch.launch.dryrun --arch granite-8b --shape
  decode_32k`` writes its artifact.
* The serve CLI with ``--mesh-model 1`` serves ``repro``'s CLI's greedy
  tokens on reduced granite-8b.
* A remat recompute whose backward runs on another thread sees the caller's
  plan.
"""

import dataclasses
import importlib
import json
import os
import subprocess
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.core import costmodel as j_costmodel
from repro.core.policies import TileConfig as JTile
from repro.core.selector import KernelSelector as JSelector
from repro.data.pipeline import input_specs as j_input_specs
from repro.dist import sharding as j_sharding
from repro.launch import serve as j_serve
from repro.models import SHAPES_BY_NAME as J_SHAPES
from repro.models import build_model as j_build_model
from repro.optim import constant as j_constant
from repro.optim import make_optimizer as j_make_optimizer
from repro.train import make_train_step as j_make_train_step
from repro.train import train_gemm_div as j_train_gemm_div
from repro_torch.configs import get_reduced
from repro_torch.core import costmodel
from repro_torch.core.gemm import gemm_context
from repro_torch.core.policies import HOPPER_TILE_CONFIGS
from repro_torch.core.selector import KernelSelector
from repro_torch.dist import sharding
from repro_torch.launch import dryrun
from repro_torch.launch import serve as t_serve
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.models.lm import LM, params_from_jax
from repro_torch.train.trainer import to_device_batch
from repro_torch.utils.trees import tree_items

ROOT = Path(__file__).resolve().parent.parent
CELLS = [(a, s) for a in ("granite-8b", "olmoe-1b-7b") for s in ("decode_32k", "train_4k")]
SINGLE_POD = SimpleNamespace(shape={"data": 16, "model": 16}, axis_names=("data", "model"))


def _selectors():
    """The H100's nominal machine and the Hopper tiles, for each package."""
    jmach = j_costmodel.Machine(**dataclasses.asdict(costmodel.H100))
    jtiles = [JTile(t.bm, t.bn, t.bk) for t in HOPPER_TILE_CONFIGS]
    return (KernelSelector(mach=costmodel.H100, tile_configs=HOPPER_TILE_CONFIGS),
            JSelector(mach=jmach, tile_configs=jtiles))


def _repro_dryrun():
    """``repro.launch.dryrun`` sets a 512-device XLA flag at import: bring the
    backend up first and put the environment back."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    mod = importlib.import_module("repro.launch.dryrun")
    if old is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = old
    return mod


def _repro_trace(arch, shape_name, selector):
    """``repro``'s divisor table for the cell and its dispatch log of
    ``jax.eval_shape`` of the step (2 layers, no plan installed)."""
    j_dry = _repro_dryrun()
    jcfg = dataclasses.replace(j_get_config(arch), n_layers=2)
    shape = J_SHAPES[shape_name]
    plan = j_sharding.ShardingPlan(SINGLE_POD, j_dry.rules_for_cell(jcfg, shape, SINGLE_POD))
    model = j_build_model(jcfg)
    ins = j_input_specs(jcfg, shape)
    tok = j_sharding.ArraySpec(tuple(ins["tokens"].shape), "int32",
                               j_dry._input_axes(jcfg, shape)["tokens"])
    div = dict(j_train_gemm_div(model, plan=plan))
    div["batch"] = j_dry._applied_divisor(plan, tok, 0)
    div.setdefault("model", 16)
    params = j_sharding.abstract_tree(model.param_specs())
    with j_sharding.use_plan(None), \
            importlib.import_module("repro.core.gemm").gemm_context(selector=selector) as ctx:
        if shape.kind == "train":
            opt = j_make_optimizer("adamw", j_constant(1e-4))
            state = {"params": params, "opt": jax.eval_shape(opt.init, params),
                     "step": jax.ShapeDtypeStruct((), jnp.int32)}
            jax.eval_shape(j_make_train_step(model, opt, div=div), state, ins)
        else:
            cache = j_sharding.abstract_tree(model.cache_specs(shape.global_batch,
                                                               shape.seq_len))
            jax.eval_shape(lambda p, c, i: model.decode_step(p, c, i["tokens"], i["cur_pos"],
                                                             div=div), params, cache, ins)
    return div, ctx.log


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_dispatch_keys_and_selections_match_repro(arch, shape):
    sel, jsel = _selectors()
    art = dryrun.lower_cell(arch, shape, False, config_overrides={"n_layers": 2}, selector=sel)
    assert art["status"] == "ok"
    jdiv, jlog = _repro_trace(arch, shape, jsel)
    assert art["config"]["div"] == jdiv
    want = {}
    for e in jlog:
        want.setdefault(f"{e.tag}:{e.local_mnk}", (e.selection.policy.name,
                                                   e.selection.cfg.name, e.selection.g))
    got = {k: (v["policy"], v["cfg"], v["g"]) for k, v in art["dispatch"].items()}
    assert got == want
    assert art["cost"]["gemm_flops"] == art["cost"]["gemm_flops_logged"] > 0
    assert art["cost"]["flops"] > art["cost"]["gemm_flops"]
    for entry in art["dispatch"].values():
        dm, dn, dk = entry["divisors"]
        assert entry["local_mnk"] == [m // d for m, d in zip(entry["global_mnk"], (dm, dn, dk))]
        assert {dm, dn, dk} <= {1, art["config"]["div"]["batch"], art["config"]["div"]["model"]}


def test_flops_and_argument_bytes_by_hand():
    """granite-8b x 2 layers, ``decode_32k`` (batch 128, 32768 positions) on
    (data 16, model 16). kv_heads (8) do not split 16 ways, so the decode
    rules keep them whole and shard the cache's positions over ``model``."""
    art = dryrun.lower_cell("granite-8b", "decode_32k", False, config_overrides={"n_layers": 2})
    d, f, v, kvd, n_l = 4096, 14336, 49152, 8 * 128, 2
    bf16, f32, i32 = 2, 4, 4
    params = (
        2 * v * d * bf16 // 256  # embed (vocab/model, embed/data) and lm_head
        + d * f32  # final norm, replicated
        + n_l * 2 * d * f32  # norm1, norm2
        + n_l * 2 * d * d * bf16 // 256  # wq, wo (embed/data, heads/model)
        + n_l * 2 * d * kvd * bf16 // 16  # wk, wv (embed/data; kv_heads whole)
        + n_l * 3 * d * f * bf16 // 256  # w_gate, w_in, w_out
    )
    cache = 2 * n_l * (128 // 16) * (32768 // 16) * kvd * bf16  # k, v (batch/data, kv_seq/model)
    inputs = 2 * (128 // 16) * i32  # tokens, cur_pos
    assert art["memory"]["argument_size"] == params + cache + inputs
    m = 128
    per_layer = 2 * m * (d * d + 2 * d * kvd + d * d + 3 * d * f)
    assert art["cost"]["gemm_flops_logged"] == n_l * per_layer + 2 * m * d * v
    assert art["cost"]["gemm_flops"] == art["cost"]["gemm_flops_logged"]
    assert art["dispatches"] == n_l * 7 + 1


def test_decode_cell_records_the_kv_seq_combine_by_hand():
    """granite-8b x 2 layers, ``decode_32k`` on (data 16, model 16): the
    rules split the cache's positions over ``model`` (8 kv heads do not
    divide it), so each attention layer all-gathers its query over
    ``model`` and combines the ranks' partial softmaxes: a max all-reduce
    of (rows, 1, kv, group) and one sum all-reduce of the rescaled
    denominators and outputs (rows, 1, kv, group, 1 + d_head), in f32."""
    art = dryrun.lower_cell("granite-8b", "decode_32k", False, config_overrides={"n_layers": 2})
    assert art["config"]["rules"]["kv_seq"] == ["pod", "data", "model"]
    assert art["config"]["rules"]["kv_heads"] is None
    rows, d, kv, group, dh, n_l = 128 // 16, 4096, 8, 4, 128, 2
    f32, bf16 = 4, 2
    combine = rows * kv * group * f32 + rows * kv * group * (1 + dh) * f32
    row_parallel = 2 * rows * d * f32  # attn.o and mlp.out, their f32 partials
    embed = rows * d * bf16
    assert art["collectives"]["all-reduce"] == {
        "count": n_l * 4 + 1, "bytes": n_l * (combine + row_parallel) + embed}
    # the queries' all-gather a layer (2 heads a rank, 32 gathered)
    assert art["collectives"]["all-gather"]["bytes"] >= n_l * rows * 32 * dh * bf16


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_train_cell_records_sequence_parallel_collectives(optimizer):
    """granite-8b x 2 layers, ``train_4k`` on (data 16, model 16), ``seq``
    on ``model``: the residual stream's gathers and reduce-scatters, and no
    all-reduce as large as one residual (the norms' gradients, Adafactor's
    factored moments and scalars are all that is all-reduced)."""
    art = dryrun.lower_cell("granite-8b", "train_4k", False, config_overrides={"n_layers": 2},
                            optimizer_name=optimizer)
    assert art["status"] == "ok" and art["config"]["rules"] == {"seq": "model"}
    coll = art["collectives"]
    assert coll is not None and "collectives_note" not in art
    residual = 256 // 16 * 4096 // 16 * 4096 * 2  # one rank's (rows, positions, D) in bf16
    # forward a layer: the gathers before attn.q/k/v and mlp.gate/in, the
    # scatters of attn.o and mlp.out (and their remat recompute); backward
    # the transposes; the embedding's scatter, the head's gather
    assert coll["reduce-scatter"]["count"] >= 4 * 2 + 1
    assert coll["reduce-scatter"]["bytes"] >= (4 * 2 + 1) * residual
    assert coll["all-gather"]["count"] >= 4 * 2 + 1
    assert 0 < coll["all-reduce"]["bytes"] < residual
    if optimizer == "adafactor":
        adamw = dryrun.lower_cell("granite-8b", "train_4k", False,
                                  config_overrides={"n_layers": 2})
        # the factored moments' and the RMS's sums across the shards
        assert coll["all-reduce"]["count"] > adamw["collectives"]["all-reduce"]["count"]
        assert art["memory"]["argument_size"] < adamw["memory"]["argument_size"]


def test_dryrun_cli_writes_its_artifact(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                          "granite-8b", "--shape", "decode_32k", "--out-dir", str(tmp_path)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    art = json.loads((tmp_path / "granite-8b__decode_32k__single_pod.json").read_text())
    assert art["status"] == "ok" and art["n_devices"] == 256
    assert art["dispatch"]["mlp.in:(8, 896, 4096)"]["epilogue"] == "mul_silu"
    assert art["config"]["div"] == {"batch": 16, "model": 16}
    skipped = dryrun.lower_cell("granite-8b", "long_500k", False)
    assert skipped["status"] == "skipped"


def test_serve_cli_mesh_model_tokens_match_repro_cli(monkeypatch, tmp_path):
    """``--mesh-model 1`` on reduced granite-8b, f32, both CLIs given
    ``repro``'s seeded weights: the same greedy tokens, and the port's
    engines take the plan's divisors (all 1 on one rank). ``repro``'s own
    ``--mesh-model 1`` raises under this jax (its one-device mesh is made
    with explicit axes, and prefill's cache update then meets a sharding
    mismatch), so the reference is ``repro``'s CLI without the flag: on one
    rank the plan's divisors are all 1 and its hints move nothing."""
    from repro.serve.engine import EngineCore as JEngineCore
    from repro_torch.serve.engine import EngineCore

    argv = ["--arch", "granite-8b", "--preset", "reduced", "--dtype", "float32", "--requests",
            "4", "--slots", "2", "--max-seq", "48", "--max-new-tokens", "6", "--seed", "0",
            "--mesh-model", "1"]
    tokens, divs = {}, []

    def recording(cls, side):
        run = cls.run

        def wrapped(self, *a, **kw):
            done = run(self, *a, **kw)
            tokens.setdefault(side, {}).update({r.uid: list(r.out_tokens) for r in done})
            if side == "port":
                divs.append(dict(self.div))
            return done
        monkeypatch.setattr(cls, "run", wrapped)

    def repro_weights(self, device=None, generator=None):
        jcfg = dataclasses.replace(j_get_reduced("granite-8b"), dtype="float32")
        jtree = j_sharding.materialize_tree(j_build_model(jcfg).param_specs(),
                                            jax.random.PRNGKey(0))
        return params_from_jax(jax.tree.map(np.asarray, jtree), device=device)

    recording(JEngineCore, "repro")
    recording(EngineCore, "port")
    monkeypatch.setattr(LM, "init_params", repro_weights)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv[:-2])
    assert j_serve.main() == 0
    summary = tmp_path / "summary.json"
    assert t_serve.main(argv + ["--device", "cpu", "--summary-json", str(summary)]) == 0
    assert len(tokens["port"]) == 4 and tokens["port"] == tokens["repro"]
    assert divs == [{"batch": 1, "model": 1}]
    mesh = json.loads(summary.read_text())["mesh"]
    assert mesh == {"shape": {"data": 1, "model": 1}, "gemm_div": {"batch": 1, "model": 1}}
    with pytest.raises(AssertionError, match="model axis of 2"):
        t_serve.main(argv[:-1] + ["2", "--device", "cpu"])


def test_remat_recompute_on_another_thread_sees_the_plan(monkeypatch):
    """The plan is thread-local, and autograd may run the backward on a
    thread of its own: every constrain hint of the recomputed layers must
    see the caller's plan there."""
    cfg = dataclasses.replace(get_reduced("granite-8b"), dtype="float32", remat=True)
    model = build_model(cfg)
    params = model.init_params("cpu")
    for _, leaf in tree_items(params):
        leaf.requires_grad_(True)
    seen = []
    real = sharding._constrain

    def spy(x, axes, uneven):
        seen.append((threading.get_ident(), sharding.current_plan()))
        return real(x, axes, uneven)

    monkeypatch.setattr(sharding, "_constrain", spy)
    r = np.random.default_rng(0)
    batch = {"tokens": r.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32),
             "labels": r.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)}
    plan = sharding.ShardingPlan(make_host_mesh(1))
    with sharding.use_plan(plan), gemm_context(device="cpu"):
        loss, _ = model.loss_fn(params, to_device_batch(batch, "cpu"))
        n_fwd = len(seen)
        worker = threading.Thread(target=loss.backward)
        worker.start()
        worker.join()
    recomputed = seen[n_fwd:]
    # the embedding's hint is outside the remat blocks; a layer's recompute
    # runs at least to its first hint (it stops once its saved tensors are back)
    assert n_fwd == 1 + 2 * cfg.n_layers and len(recomputed) >= cfg.n_layers
    assert all(tid == worker.ident and p is plan for tid, p in recomputed)
    assert all(p is plan for _, p in seen[:n_fwd])
