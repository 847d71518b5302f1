"""Parity of the port's distribution planning with the JAX package, on stub
meshes (a ``shape`` mapping and ``axis_names``: the solver needs no devices).

* ``ShardingPlan.spec_for`` of every parameter and cache leaf of all ten
  configs, at every applicable shape cell and on the meshes (16, 16),
  (2, 16, 16) and (32, 8), under the cell's ``rules_for_cell``, equals
  ``repro``'s ``PartitionSpec`` entry for entry;
* ``demoted_dims``, ``gemm_div``, ``rules_for_cell``, ``_applied_divisor``,
  ``serve_gemm_div`` and ``train_gemm_div`` equal ``repro``'s;
* ``input_specs`` has ``repro``'s shapes and dtypes;
* ``make_host_mesh`` refuses a model axis the ranks do not split into;
* ``pipeline_apply`` equals applying the stages in order, bitwise in f32,
  locally and across two ``gloo`` ranks;
* the plan is thread-local, ``constrain`` checks its hint under a plan and
  returns its input, and ``placements_for`` gives DTensor placements.
"""

import importlib
import os
import socket
import subprocess
import sys
import textwrap
import threading
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data.pipeline import input_specs as j_input_specs
from repro.dist import sharding as j_sharding
from repro.models import build_model as j_build_model
from repro.serve.engine import serve_gemm_div as j_serve_gemm_div
from repro.train.trainer import train_gemm_div as j_train_gemm_div
from repro_torch.configs import get_config, list_archs
from repro_torch.data import input_specs
from repro_torch.dist import sharding
from repro_torch.dist.pipeline import pipeline_apply, split_stages
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import applicable_shapes, build_model
from repro_torch.serve.engine import serve_gemm_div
from repro_torch.train.trainer import train_gemm_div

ROOT = Path(__file__).resolve().parent.parent
MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "32x8": {"data": 32, "model": 8},
}


def _mesh(name):
    shape = MESHES[name]
    return SimpleNamespace(shape=dict(shape), axis_names=tuple(shape))


def _repro_dryrun():
    """``repro.launch.dryrun`` sets a 512-device XLA flag at import: bring the
    backend up first and put the environment back, so this process keeps
    its one CPU device."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    mod = importlib.import_module("repro.launch.dryrun")
    if old is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = old
    return mod


def _spec_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _spec_leaves(tree[key], f"{prefix}{key}/")
    else:
        yield prefix[:-1], tree


def _cells(arch):
    cfg = get_config(arch)
    for shape in applicable_shapes(cfg):
        for mesh in MESHES:
            yield cfg, shape, mesh


def _pair_plans(j_dry, cfg, jcfg, shape, mesh_name):
    mesh = _mesh(mesh_name)
    rules = dryrun.rules_for_cell(cfg, shape, mesh)
    assert rules == j_dry.rules_for_cell(jcfg, shape, mesh)
    return sharding.ShardingPlan(mesh, rules), j_sharding.ShardingPlan(mesh, rules)


@pytest.mark.parametrize("arch", list_archs())
def test_spec_for_matches_repro_on_every_leaf(arch):
    j_dry = _repro_dryrun()
    cfg, jcfg = get_config(arch), j_get_config(arch)
    model, jmodel = build_model(cfg), j_build_model(jcfg)
    specs, jspecs = model.param_specs(), jmodel.param_specs()
    checked = 0
    for _, shape, mesh_name in _cells(arch):
        plan, jplan = _pair_plans(j_dry, cfg, jcfg, shape, mesh_name)
        caches = model.cache_specs(shape.global_batch, shape.seq_len)
        jcaches = jmodel.cache_specs(shape.global_batch, shape.seq_len)
        for tree, jtree in ((specs, jspecs), (caches, jcaches)):
            got, want = dict(_spec_leaves(tree)), dict(_spec_leaves(jtree))
            assert got.keys() == want.keys()
            for path, spec in got.items():
                jspec = want[path]
                assert (spec.shape, spec.axes, spec.dtype) == (jspec.shape, jspec.axes,
                                                               jspec.dtype), path
                for uneven in (False, True):
                    assert plan.spec_for(spec, uneven=uneven) == tuple(
                        jplan.spec_for(jspec, uneven=uneven)), (path, shape.name, mesh_name)
                checked += 1
    assert checked > 100


@pytest.mark.parametrize("arch", list_archs())
def test_divisor_tables_match_repro(arch):
    """``gemm_div``, ``demoted_dims``, ``_applied_divisor`` and the serve and
    train tables (at the cell's batch and at an indivisible one)."""
    j_dry = _repro_dryrun()
    cfg, jcfg = get_config(arch), j_get_config(arch)
    model, jmodel = build_model(cfg), j_build_model(jcfg)
    specs, jspecs = model.param_specs(), jmodel.param_specs()
    for _, shape, mesh_name in _cells(arch):
        plan, jplan = _pair_plans(j_dry, cfg, jcfg, shape, mesh_name)
        assert plan.gemm_div() == jplan.gemm_div()
        for axis in ("model", "data"):
            assert plan.demoted_dims(specs, mesh_axis=axis) == jplan.demoted_dims(
                jspecs, mesh_axis=axis)
        ins, jins = input_specs(cfg, shape), j_input_specs(jcfg, shape)
        axes = dryrun._input_axes(cfg, shape)
        assert axes == j_dry._input_axes(jcfg, shape)
        for key, v in ins.items():
            spec = sharding.ArraySpec(tuple(v.shape), "int32", axes[key])
            jspec = j_sharding.ArraySpec(tuple(jins[key].shape), "int32", axes[key])
            for dim in range(len(spec.shape) + 1):
                assert dryrun._applied_divisor(plan, spec, dim) == j_dry._applied_divisor(
                    jplan, jspec, dim)
        for batch in (None, shape.global_batch, 6):
            assert train_gemm_div(model, batch, plan=plan) == j_train_gemm_div(
                jmodel, batch, plan=jplan)
            with sharding.use_plan(plan), j_sharding.use_plan(jplan):
                assert serve_gemm_div(model, batch) == j_serve_gemm_div(jmodel, batch)
                assert train_gemm_div(model, batch) == j_train_gemm_div(jmodel, batch)
    assert serve_gemm_div(model) == {} and train_gemm_div(model) == {}


@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_match_repro(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for shape in applicable_shapes(cfg):
        got, want = input_specs(cfg, shape), j_input_specs(jcfg, shape)
        assert got.keys() == want.keys()
        for key, v in got.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(want[key].shape)
            assert str(v.dtype).removeprefix("torch.") == str(want[key].dtype)


def test_production_and_host_meshes():
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16} and multi.size == 512
    assert make_production_mesh(shape=(32, 8)).shape == {"data": 32, "model": 8}
    assert make_production_mesh(multi_pod=True, shape=(32, 8)).size == 512
    with pytest.raises(AssertionError, match="256/512"):
        make_production_mesh(shape=(8, 8))
    host = make_host_mesh(model=1)
    assert host.shape == {"data": 1, "model": 1}
    with pytest.raises(AssertionError, match="model axis of 2"):
        make_host_mesh(model=2)
    plan = sharding.ShardingPlan(host)
    assert plan.gemm_div() == {"batch": 1, "model": 1}


def test_plan_is_thread_local_and_constrain_checks_its_hint():
    plan = sharding.ShardingPlan(_mesh("16x16"))
    x = torch.zeros(4, 8, 16)
    seen = []
    with sharding.use_plan(plan):
        assert sharding.current_plan() is plan
        assert sharding.constrain(x, "batch", "seq", None) is x
        assert sharding.constrain_uneven(x, "batch", None, "heads") is x
        with pytest.raises(ValueError, match="rank mismatch"):
            sharding.constrain(x, "batch", None)
        worker = threading.Thread(target=lambda: seen.append(sharding.current_plan()))
        worker.start()
        worker.join()
    assert seen == [None] and sharding.current_plan() is None
    assert sharding.constrain(x, "batch", None) is x  # no plan: no check


def test_placements_and_trees():
    from torch.distributed.tensor import Replicate, Shard

    plan = sharding.ShardingPlan(_mesh("2x16x16"))
    spec = sharding.ArraySpec((256, 4096, 14336), "bfloat16", ("batch", "embed", "ffn"))
    entries = plan.spec_for(spec)
    assert entries == (("pod", "data"), None, "model")
    assert plan.local_shape(spec) == (8, 4096, 896)
    assert sharding.placements_for(entries, _mesh("2x16x16")) == (Shard(0), Shard(0), Shard(2))
    dm = SimpleNamespace(mesh_dim_names=("data", "model"))
    assert sharding.placements_for((None, "model"), dm) == (Replicate(), Shard(1))
    tree = {"w": spec, "n": {"s": sharding.ArraySpec((7,), "float32", (None,), init="ones")}}
    abstract = sharding.abstract_tree(tree)
    assert abstract["w"].device.type == "meta" and abstract["w"].dtype == torch.bfloat16
    real = sharding.materialize_tree({"n": tree["n"]}, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(real["n"]["s"], torch.ones(7))


#: the stages and their inputs, shared with the ranked run's processes
#: (which import neither jax nor this module)
STAGES = textwrap.dedent("""
    def _stage_fn(p, h):
        for i in range(p["w"].shape[0]):
            h = torch.tanh(h @ p["w"][i] + p["b"][i])
        return h


    def _pipeline_inputs():
        r = np.random.default_rng(3)
        params = {"w": torch.from_numpy(r.normal(size=(8, 16, 16)).astype(np.float32) / 4),
                  "b": torch.from_numpy(r.normal(size=(8, 16)).astype(np.float32))}
        x = torch.from_numpy(r.normal(size=(5, 3, 16)).astype(np.float32))
        return params, x
""")
exec(STAGES)


def _sequential(params, x):
    return torch.stack([_stage_fn(params, x[m]) for m in range(x.shape[0])])


@pytest.mark.parametrize("n_stages", [1, 2, 4, 8])
def test_pipeline_apply_equals_sequential_application(n_stages):
    params, x = _pipeline_inputs()
    staged = split_stages(params, n_stages)
    assert staged["w"].shape == (n_stages, 8 // n_stages, 16, 16)
    got = pipeline_apply(_stage_fn, staged, x)
    assert torch.equal(got, _sequential(params, x))
    with pytest.raises(AssertionError, match="not divisible"):
        split_stages(params, 3)


RANKED = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.dist.pipeline import pipeline_apply, split_stages
{stages}
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method="tcp://localhost:{port}", world_size=2, rank=rank)
params, x = _pipeline_inputs()
out = pipeline_apply(_stage_fn, split_stages(params, 4), x)
np.save({out!r} + f".{{rank}}.npy", out.numpy())
dist.destroy_process_group()
"""


def test_pipeline_apply_across_two_gloo_ranks(tmp_path):
    if not torch.distributed.is_available() or not torch.distributed.is_gloo_available():
        pytest.skip("torch.distributed without gloo")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = RANKED.format(stages=STAGES, port=port, out=str(tmp_path / "out"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err.decode()[-2000:]
    params, x = _pipeline_inputs()
    want = _sequential(params, x).numpy()
    for r in range(2):
        got = np.load(tmp_path / f"out.{r}.npy")
        assert np.array_equal(got, want), r
