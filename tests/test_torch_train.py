"""The port's training stack against ``repro``'s on the CPU.

* The schedules at steps 0-50 (within two f32 ulps); ``AdamW``, ``SGD`` and ``Adafactor``
  over three updates of a seeded tree with f32 and bf16 leaves, state
  included, and ``clip_by_global_norm`` (1e-6).
* ``SyntheticLMData.batch_at`` byte for byte ``repro``'s for all ten
  configs (patches and frames included), and its state round trip.
* ``quantize_int8``, ``compress_decompress`` and ``ErrorFeedback`` equal to
  ``repro``'s.
* granite-8b and olmoe-1b-7b, reduced and in f32, through ``Trainer.fit``
  for 5 steps, plain, with 4 microbatches and with gradient compression:
  the loss history within 1e-4 relative of ``repro``'s ``Trainer``, and
  every parameter leaf within 1e-4 in relative L2 norm (1e-3 with
  compression: a gradient element near a boundary of the int8 grid rounds
  to the next code in one implementation and not the other, and AdamW's
  first steps move it by about the learning rate whatever its size).
* The port's checkpoint resume, bitwise, as ``tests/test_train.py`` holds
  ``repro``'s; a checkpoint written by ``repro`` at step 3 restored by the
  port (bf16 leaves bitwise) and continued to step 5, against ``repro``'s
  uninterrupted history (1e-4; 1e-3 in bf16, where the two implementations'
  uninterrupted runs already differ by up to 4.1e-4); a checkpoint written
  by the port restored by ``repro`` bitwise (f32), and bf16 leaves stored in
  ``repro``'s bytes.
* The CLI on the CPU.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_reduced as j_get_reduced
from repro.data import SyntheticLMData as JData
from repro.dist import compression as j_comp
from repro.dist.sharding import materialize_tree
from repro.models import build_model as j_build_model
from repro.optim import clip_by_global_norm as j_clip
from repro.optim import constant as j_constant
from repro.optim import make_optimizer as j_make_optimizer
from repro.optim import warmup_cosine as j_warmup_cosine
from repro.optim import warmup_linear as j_warmup_linear
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import init_train_state as j_init_train_state
from repro.utils import trees as j_trees
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_reduced, list_archs
from repro_torch.data import SyntheticLMData
from repro_torch.dist import compression as comp
from repro_torch.models import build_model
from repro_torch.models.lm import params_from_jax
from repro_torch.optim import clip_by_global_norm, constant, make_optimizer, warmup_cosine
from repro_torch.optim import warmup_linear
from repro_torch.train import StragglerMonitor, Trainer, TrainerConfig, init_train_state
from repro_torch.utils.timing import Timer
from repro_torch.utils.trees import tree_bytes, tree_count, tree_global_norm, tree_items, tree_paths

ROOT = Path(__file__).resolve().parent.parent


def _np(tree):
    """A jax tree as {path: numpy array} (bfloat16 kept as ml_dtypes)."""
    return dict(tree_items(jax.tree.map(np.asarray, tree)))


def _f32(a):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.astype(np.float32)


# ---------------------------------------------------------------------------
# schedules and optimizers
# ---------------------------------------------------------------------------

SCHEDULES = {
    "warmup_cosine": (warmup_cosine(3e-4, 5, 40), j_warmup_cosine(3e-4, 5, 40)),
    "warmup_cosine_min": (warmup_cosine(1e-2, 0, 30, min_ratio=0.3),
                          j_warmup_cosine(1e-2, 0, 30, min_ratio=0.3)),
    "warmup_linear": (warmup_linear(3e-4, 5, 40), j_warmup_linear(3e-4, 5, 40)),
    "constant": (constant(2e-3), j_constant(2e-3)),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_repro(name):
    mine, ref = SCHEDULES[name]
    for step in range(51):
        want = float(ref(jnp.asarray(step, jnp.int32)))
        got = mine(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        # two f32 ulps (at most 2.4e-7 relative): XLA's and torch's f32 cos
        # round one ulp apart at a few steps, and the products after it carry that
        np.testing.assert_array_max_ulp(np.float32(float(got)), np.float32(want), maxulp=2)
        assert float(mine(step)) == float(got)


def _opt_tree(seed):
    r = np.random.default_rng(seed)
    return {
        "a": r.normal(size=(6, 5)).astype(np.float32),
        "b": {"c": r.normal(size=(4, 3, 2)).astype(np.float32),
              "d": r.normal(size=(7,)).astype(np.float32)},
        "e": r.normal(size=(3, 8)).astype(np.float32),
    }


def _as_jax(tree):
    out = jax.tree.map(jnp.asarray, tree)
    out["b"]["c"] = out["b"]["c"].astype(jnp.bfloat16)
    out["e"] = out["e"].astype(jnp.bfloat16)
    return out


def _as_torch(tree):
    out = jax.tree.map(torch.tensor, tree)
    out["b"]["c"] = out["b"]["c"].to(torch.bfloat16)
    out["e"] = out["e"].to(torch.bfloat16)
    return out


def _close_trees(got, want, rtol, what):
    want = _np(want)
    got = dict(tree_items(got))
    assert sorted(got) == sorted(want), what
    for name, ref in want.items():
        g = got[name]
        assert isinstance(g, torch.Tensor), (what, name)
        assert str(g.dtype).removeprefix("torch.") == str(ref.dtype), (what, name)
        ref32 = ref.astype(np.float32)
        scale = max(np.abs(ref32).max(), 1e-30)
        np.testing.assert_allclose(_f32(g), ref32, rtol=0, atol=rtol * scale,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("name,kw", [("adamw", {}), ("adamw", dict(weight_decay=0.0, b2=0.999)),
                                     ("sgd", {}), ("sgd", dict(momentum=0.0)),
                                     ("adafactor", {}), ("adafactor", dict(max_grad_norm=1e3))])
def test_optimizers_match_repro_over_three_updates(name, kw):
    mine = make_optimizer(name, warmup_cosine(1e-2, 2, 10), **kw)
    ref = j_make_optimizer(name, j_warmup_cosine(1e-2, 2, 10), **kw)
    jp, tp = _as_jax(_opt_tree(0)), _as_torch(_opt_tree(0))
    js, ts = ref.init(jp), mine.init(tp)
    _close_trees(ts, js, 0, "init")
    for step in range(3):
        grads = _opt_tree(10 + step)
        jg, tg = _as_jax(grads), _as_torch(grads)
        jp, js, jm = ref.update(jg, js, jp)
        tp, ts, tm = mine.update(tg, ts, tp)
        _close_trees(tp, jp, 1e-6, f"params {step}")
        _close_trees(ts, js, 1e-6, f"state {step}")
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-6, err_msg=key)
    assert int(ts["count"]) == 3 and ts["count"].dtype == torch.int32


def test_clip_by_global_norm_matches_repro():
    for max_norm in (0.5, 1e3):
        grads = _opt_tree(3)
        jc, jn = j_clip(_as_jax(grads), max_norm)
        tc, tn = clip_by_global_norm(_as_torch(grads), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        np.testing.assert_allclose(float(tree_global_norm(_as_torch(grads))), float(jn),
                                   rtol=1e-6)
        _close_trees(tc, jc, 1e-6, "clipped")


def test_tree_helpers_match_repros():
    tree = _opt_tree(0)
    tt, jt = _as_torch(tree), _as_jax(tree)
    assert tree_paths(tt) == list(_np(jt)) == j_trees.tree_paths(jt)
    assert tree_count(tt) == j_trees.tree_count(jt)
    assert tree_bytes(tt) == j_trees.tree_bytes(jt)


# ---------------------------------------------------------------------------
# data and compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list(list_archs()))
def test_synthetic_batches_are_repros_byte_for_byte(arch):
    cfg, jcfg = get_reduced(arch), j_get_reduced(arch)
    mine = SyntheticLMData(cfg, batch=3, seq_len=40, seed=7, mean_doc_len=9)
    ref = JData(jcfg, batch=3, seq_len=40, seed=7, mean_doc_len=9)
    for step in (0, 1, 5):
        got, want = mine.batch_at(step), ref.batch_at(step)
        assert sorted(got) == sorted(want)
        if cfg.family == "vlm":
            assert "patch_embeds" in got
        if cfg.family == "encdec":
            assert "frames" in got
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            assert got[key].tobytes() == want[key].tobytes(), (step, key)


def test_data_state_round_trip():
    cfg = get_reduced("granite-8b")
    data = SyntheticLMData(cfg, batch=2, seq_len=16, seed=4)
    it = iter(data)
    first = [next(it) for _ in range(3)]
    saved = data.state_dict()
    assert saved == {"seed": 4, "step": 3}
    nxt = next(it)
    other = SyntheticLMData(cfg, batch=2, seq_len=16, seed=0)
    other.load_state_dict(saved)
    again = next(iter(other))
    assert all(np.array_equal(nxt[k], again[k]) for k in nxt)
    assert np.array_equal(first[1]["tokens"], data.batch_at(1)["tokens"])


def test_compression_matches_repro():
    r = np.random.default_rng(2)
    x = (r.normal(size=(64, 33)) * 3e-3).astype(np.float32)
    q, s = comp.quantize_int8(torch.tensor(x))
    jq, js = j_comp.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    xhat, res = comp.compress_decompress(torch.tensor(x))
    jxhat, jres = j_comp.compress_decompress(jnp.asarray(x))
    assert np.array_equal(xhat.numpy(), np.asarray(jxhat))
    assert np.array_equal(res.numpy(), np.asarray(jres))
    grads, jgrads = _as_torch(_opt_tree(8)), _as_jax(_opt_tree(8))
    res_t, res_j = comp.ErrorFeedback.init(grads), j_comp.ErrorFeedback.init(jgrads)
    for _ in range(3):
        ghat, res_t = comp.ErrorFeedback.apply(grads, res_t)
        jghat, res_j = j_comp.ErrorFeedback.apply(jgrads, res_j)
        _close_trees(ghat, jghat, 0, "ghat")
        _close_trees(res_t, res_j, 0, "residuals")


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

STEPS = 5


@functools.lru_cache(maxsize=None)
def _jparams(arch, dtype="float32"):
    jcfg = dataclasses.replace(j_get_reduced(arch), dtype=dtype)
    jmodel = j_build_model(jcfg)
    return jcfg, jmodel, jax.tree.map(np.asarray, materialize_tree(
        jmodel.param_specs(), jax.random.PRNGKey(0)))


def _schedule(lib):
    return (warmup_cosine if lib == "torch" else j_warmup_cosine)(3e-3, 2, STEPS)


def _tcfg(cls, **kw):
    return cls(log_every=100, **kw)


@functools.lru_cache(maxsize=None)
def _repro_fit(arch, microbatches=1, compression=False, dtype="float32", steps=STEPS,
               ckpt_dir=None):
    jcfg, jmodel, jparams = _jparams(arch, dtype)
    opt = j_make_optimizer("adamw", _schedule("jax"))
    t = JTrainer(jmodel, opt, JData(jcfg, batch=4, seq_len=16, seed=1),
                 _tcfg(JTrainerConfig, total_steps=steps, microbatches=microbatches,
                       grad_compression=compression, ckpt_dir=ckpt_dir, ckpt_every=100))
    state = t.fit(j_init_train_state(jmodel, opt, jax.tree.map(jnp.asarray, jparams),
                                     compression))
    return t.history, _np(state["params"])


def _port_trainer(arch, dtype="float32", steps=STEPS, **kw):
    _, _, jparams = _jparams(arch, dtype)
    cfg = dataclasses.replace(get_reduced(arch), dtype=dtype)
    model = build_model(cfg)
    opt = make_optimizer("adamw", _schedule("torch"))
    t = Trainer(model, opt, SyntheticLMData(cfg, batch=4, seq_len=16, seed=1),
                _tcfg(TrainerConfig, total_steps=steps, ckpt_every=100, **kw))
    return t, init_train_state(model, opt, params_from_jax(jparams, device="cpu"),
                               kw.get("grad_compression", False))


@pytest.mark.parametrize("arch", ["granite-8b", "olmoe-1b-7b"])
@pytest.mark.parametrize("mode", ["plain", "microbatches", "compression"])
def test_trainer_matches_repros_trainer(arch, mode):
    kw = dict(microbatches=4 if mode == "microbatches" else 1,
              grad_compression=mode == "compression")
    want_hist, want_params = _repro_fit(arch, kw["microbatches"], kw["grad_compression"])
    t, state = _port_trainer(arch, **kw)
    state = t.fit(state)
    np.testing.assert_allclose(t.history, want_hist, rtol=1e-4)
    assert int(state["step"]) == STEPS and int(state["opt"]["count"]) == STEPS
    tol = 1e-3 if kw["grad_compression"] else 1e-4
    for name, p in tree_items(state["params"]):
        ref = want_params[name]
        rel = np.linalg.norm(_f32(p) - ref) / np.linalg.norm(ref)
        assert rel <= tol, (name, rel)


def _cfg_tiny():
    cfg = dataclasses.replace(get_reduced("granite-8b"), dtype="float32")
    return cfg, build_model(cfg)


def test_checkpoint_resume_bitwise(tmp_path):
    """As ``tests/test_train.py``'s: a run that crashes at step 7 and resumes
    from its step-5 checkpoint gives the uninterrupted run's last losses,
    bit for bit."""
    cfg, model = _cfg_tiny()
    opt = make_optimizer("adamw", warmup_cosine(1e-3, 2, 30))
    fresh = lambda: model.init_params("cpu", torch.Generator().manual_seed(0))

    def run(d, injector=None, **kw):
        t = Trainer(model, opt, SyntheticLMData(cfg, batch=4, seq_len=32, seed=3),
                    TrainerConfig(total_steps=12, ckpt_dir=str(d), log_every=100, **kw),
                    failure_injector=injector)
        return t, t.fit(init_train_state(model, opt, fresh()))

    t_ref, _ = run(tmp_path / "ref", ckpt_every=100)
    crash = {"armed": True}

    def boom(step):
        if step == 7 and crash["armed"]:
            crash["armed"] = False
            raise RuntimeError("injected")

    with pytest.raises(RuntimeError, match="injected"):
        run(tmp_path / "crash", boom, ckpt_every=5, async_ckpt=False)
    t2, state = run(tmp_path / "crash", ckpt_every=5, async_ckpt=False)
    assert t2.history == t_ref.history[5:]
    assert all(p.requires_grad for _, p in tree_items(state["params"]))
    assert CheckpointManager(str(tmp_path / "crash")).all_steps() == [5, 10, 12]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_checkpoint_written_by_repro_resumes_in_the_port(tmp_path, dtype):
    arch = "granite-8b"
    want_hist, want_params = _repro_fit(arch, dtype=dtype)
    d = str(tmp_path / "ckpt")
    _repro_fit.__wrapped__(arch, dtype=dtype, steps=3, ckpt_dir=d)
    t, state = _port_trainer(arch, dtype=dtype, ckpt_dir=d)
    # the restore alone: every leaf bit for bit what repro wrote
    restored, step = t.maybe_restore(state)
    assert step == 3
    blob = np.load(os.path.join(d, "step_0000000003", "arrays.npz"))
    for name, leaf in tree_items(restored):
        raw = blob[name]
        assert tuple(leaf.shape) == raw.shape, name
        if leaf.dtype == torch.bfloat16:
            assert np.array_equal(leaf.detach().view(torch.int16).numpy(), raw.view(np.int16))
        else:
            assert np.array_equal(leaf.detach().numpy(), raw), name
    t, state = _port_trainer(arch, dtype=dtype, ckpt_dir=d)
    state = t.fit(state)
    # bf16: the two implementations' uninterrupted bf16 runs already differ by
    # up to 4.1e-4 relative (XLA rounds its fused bf16 elementwise ops once,
    # torch op by op), so the bf16 continuation is held at 1e-3
    np.testing.assert_allclose(t.history, want_hist[3:],
                               rtol=1e-4 if dtype == "float32" else 1e-3)
    assert str(state["params"]["embed"].dtype) == f"torch.{dtype}"


def test_a_checkpoint_written_by_the_port_restores_in_repro(tmp_path):
    _, _, jparams = _jparams("granite-8b")
    tree = {"params": params_from_jax(jparams, device="cpu"),
            "step": torch.tensor(4, dtype=torch.int32)}
    CheckpointManager(str(tmp_path)).save(4, tree, extra={"data": {"seed": 1, "step": 4}})
    target = {"params": jax.tree.map(jnp.asarray, jparams), "step": jnp.zeros((), jnp.int32)}
    got, step = JCheckpointManager(str(tmp_path)).restore(target)
    assert step == 4 and int(got["step"]) == 4
    assert JCheckpointManager(str(tmp_path)).read_extra(4) == {"data": {"seed": 1, "step": 4}}
    want = _np(jparams)
    for name, leaf in _np(got["params"]).items():
        assert leaf.dtype == want[name].dtype, name
        assert leaf.tobytes() == want[name].tobytes(), name


def test_bf16_leaves_are_stored_as_repro_stores_them(tmp_path):
    """The same bf16 tree saved by both managers: the same ``|V2`` records,
    byte for byte, and the same ``meta.json`` entries. (``repro``'s own
    ``restore`` cannot cast ``|V2`` back to bfloat16, its own files
    included; the port rebuilds them from ``meta.json``'s dtype.)"""
    _, _, jparams = _jparams("granite-8b", "bfloat16")
    JCheckpointManager(str(tmp_path / "j")).save(2, {"params": jax.tree.map(jnp.asarray, jparams)})
    CheckpointManager(str(tmp_path / "t")).save(2, {"params": params_from_jax(jparams, "cpu")})
    blobs = [np.load(tmp_path / d / "step_0000000002" / "arrays.npz") for d in "jt"]
    metas = [json.loads((tmp_path / d / "step_0000000002" / "meta.json").read_text())
             for d in "jt"]
    assert metas[0]["arrays"] == metas[1]["arrays"]
    assert sorted(blobs[0].files) == sorted(blobs[1].files)
    for name in blobs[0].files:
        a, b = blobs[0][name], blobs[1][name]
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), name
    assert any(blobs[1][n].dtype == np.dtype("V2") for n in blobs[1].files)


def test_straggler_monitor_and_timer():
    m = StragglerMonitor(k=3.0)
    for _ in range(20):
        m.observe(0.1)
    assert m.flagged == 0
    assert m.observe(10.0) is True and m.flagged == 1
    with Timer("cpu") as t:
        sum(range(1000))
    assert t.seconds > 0


def test_cli_trains_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "granite-8b", "--preset",
         "reduced", "--steps", "5", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    line = [ln for ln in out.stderr.splitlines() if "final loss" in ln][-1]
    final = float(line.split("final loss")[1].split()[0])
    assert np.isfinite(final)
