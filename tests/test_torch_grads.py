"""Gradients of the port against ``jax.grad`` of ``repro`` on the CPU, for
all ten of ``repro``'s configs, reduced, in f32, ``repro``'s parameters
carried across by ``params_from_jax`` and one batch of the synthetic
stream (B = 2, S = 16, an attention chunk of 8 so the online softmax runs
over two chunks).

* ``loss_fn``'s loss and metrics against ``repro``'s at 1e-5 (llava with
  its patch positions masked, whisper through ``EncDec.loss_fn``).
* Every gradient leaf against ``jax.grad`` within 1e-4 x max|g| of the
  leaf, through the ``torch`` backend (autograd) and through the ``cuda``
  backend on CPU tensors (the kernels' plain versions inside
  :class:`~repro_torch.core.gemm.GemmGrad`); every leaf has a gradient.
* ``remat`` on and off, and ``attn_remat`` on, give the same gradients; a
  backward on another thread (as autograd runs a CUDA backward) recomputes
  the layers under the caller's dispatch context.
* The forward op keys and tags, in order of first appearance, equal
  ``repro``'s selection log for the same step.
* ``GemmGrad`` alone: each epilogue's VJP against autograd through the
  ``torch`` backend (plain, grouped fused and loop, batched; f32 and
  bf16), relu and squared ReLU at exact zeros against ``jax.grad``; a
  dispatch without grad never enters it; a quantized weight under grad is
  refused.
"""

import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.core.gemm import gemm_context as j_gemm_context
from repro.core.op import Epilogue as JEpilogue
from repro.dist.sharding import materialize_tree
from repro.models import build_model as j_build_model
from repro_torch.configs import get_reduced, list_archs
from repro_torch.core import gemm as gemm_mod
from repro_torch.core.gemm import gemm, gemm_batched, gemm_context, gemm_grouped
from repro_torch.core.op import Epilogue
from repro_torch.core.quant import quantize_weight
from repro_torch.data import SyntheticLMData
from repro_torch.models import build_model
from repro_torch.models.lm import params_from_jax
from repro_torch.train.trainer import to_device_batch
from repro_torch.utils.trees import tree_items

ARCHS = list(list_archs())
OVER = dict(dtype="float32", attn_chunk=8)
B, S = 2, 16


@functools.lru_cache(maxsize=None)
def _jax_side(arch):
    """repro's model, parameters (numpy) and batch (numpy) of ``arch``."""
    jcfg = dataclasses.replace(j_get_reduced(arch), **OVER)
    jmodel = j_build_model(jcfg)
    jparams = materialize_tree(jmodel.param_specs(), jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_reduced(arch), **OVER)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    batch = SyntheticLMData(cfg, batch=B, seq_len=S, seed=1, mean_doc_len=6).batch_at(0)
    return jmodel, jax.tree.map(np.asarray, jparams), batch


@functools.lru_cache(maxsize=None)
def _ref(arch):
    """repro's (loss, metrics, {leaf path: gradient}, [(tag, op key)] in
    order of first appearance) of one step."""
    jmodel, jparams, batch = _jax_side(arch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with j_gemm_context() as ctx:
        (loss, metrics), grads = jax.value_and_grad(
            lambda p: jmodel.loss_fn(p, jb), has_aux=True)(jax.tree.map(jnp.asarray, jparams))
    keys = list(dict.fromkeys((e.tag, e.op.key) for e in ctx.log))
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            dict(tree_items(jax.tree.map(np.asarray, grads))), keys)


def _port(arch, backend="torch", **cfg_over):
    """The port's (loss, metrics, {leaf path: gradient}, keys) of the same
    step on ``backend``, the config changed by ``cfg_over``."""
    _, jparams, batch = _jax_side(arch)
    cfg = dataclasses.replace(get_reduced(arch), **OVER, **cfg_over)
    model = build_model(cfg)
    params = params_from_jax(jparams, device="cpu")
    for _, leaf in tree_items(params):
        leaf.requires_grad_(True)
    with gemm_context(backend=backend, device="cpu") as ctx:
        loss, metrics = model.loss_fn(params, to_device_batch(batch, "cpu"))
        loss.backward()
    keys = list(dict.fromkeys((e.tag, e.op.key) for e in ctx.log))
    grads = {name: leaf.grad for name, leaf in tree_items(params)}
    return float(loss.detach()), {k: float(v) for k, v in metrics.items()}, grads, keys


@functools.lru_cache(maxsize=None)
def _port_cached(arch, backend):
    return _port(arch, backend)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_metrics_match_repro(arch):
    loss, metrics, _, _ = _port_cached(arch, "torch")
    j_loss, j_metrics, _, _ = _ref(arch)
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
    assert sorted(metrics) == sorted(j_metrics)
    for key, want in j_metrics.items():
        np.testing.assert_allclose(metrics[key], want, rtol=1e-5, atol=1e-8, err_msg=key)
    if arch == "llava-next-34b":
        # the patch positions carry no loss
        cfg = get_reduced(arch)
        _, _, batch = _jax_side(arch)
        assert metrics["ntokens"] == batch["loss_mask"][:, cfg.n_patches:].sum()


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_every_gradient_leaf_matches_jax_grad(arch, backend):
    _, _, grads, _ = _port_cached(arch, backend)
    _, _, want, _ = _ref(arch)
    assert sorted(grads) == sorted(want)
    missing = [name for name, g in grads.items() if g is None]
    assert not missing, f"no gradient reached {missing}"
    for name, ref in want.items():
        got = grads[name].numpy()
        scale = max(np.abs(ref).max(), 1e-30)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * scale, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_op_keys_match_repro(arch):
    assert _port_cached(arch, "cuda")[3] == _ref(arch)[3]
    assert _port_cached(arch, "torch")[3] == _ref(arch)[3]


@pytest.mark.parametrize("arch", ["granite-8b", "olmoe-1b-7b", "zamba2-1.2b",
                                  "whisper-large-v3"])
def test_remat_on_and_off_give_the_same_gradients(arch):
    _, _, base, _ = _port_cached(arch, "torch")  # remat on: the configs' default
    assert get_reduced(arch).remat
    for over in (dict(remat=False), dict(remat=True, attn_remat=True),
                 dict(remat=False, attn_remat=True)):
        _, _, grads, _ = _port(arch, **over)
        for name, want in base.items():
            assert torch.equal(grads[name], want), (over, name)


def test_a_remat_recompute_dispatches_under_the_callers_context(monkeypatch):
    """The dispatch context is thread-local, and autograd runs a CUDA
    backward on a thread of its own. Run the backward on another thread
    here: each recomputed layer must dispatch on the caller's backend (the
    kernels, through ``GemmGrad``) into the caller's log, and the gradients
    must be those of a backward on the caller's thread."""
    arch = "granite-8b"
    _, jparams, batch = _jax_side(arch)
    model = build_model(dataclasses.replace(get_reduced(arch), **OVER))
    params = params_from_jax(jparams, device="cpu")
    for _, leaf in tree_items(params):
        leaf.requires_grad_(True)
    applied = []
    real = gemm_mod.GemmGrad.apply
    monkeypatch.setattr(gemm_mod.GemmGrad, "apply", lambda *a: applied.append(1) or real(*a))
    with gemm_context(backend="cuda", device="cpu") as ctx:
        loss, _ = model.loss_fn(params, to_device_batch(batch, "cpu"))
        n_fwd = len(ctx.log)
        worker = threading.Thread(target=loss.backward)
        worker.start()
        worker.join()
    # every dispatch again but the head's, which is outside the remat blocks
    assert len(ctx.log) == 2 * n_fwd - 1 and len(applied) == 2 * n_fwd - 1
    assert [e.tag for e in ctx.log[n_fwd:]] == [e.tag for e in ctx.log[: n_fwd - 1]]
    want = _port_cached(arch, "cuda")[2]
    for name, leaf in tree_items(params):
        assert torch.equal(leaf.grad, want[name]), name


# ---------------------------------------------------------------------------
# GemmGrad on its own
# ---------------------------------------------------------------------------

EPILOGUES = [Epilogue(), Epilogue(bias=True), Epilogue(activation="relu"),
             Epilogue(activation="gelu"), Epilogue(activation="silu"),
             Epilogue(activation="square"), Epilogue(binary="mul_silu"),
             Epilogue(binary="add"), Epilogue(activation="gelu", bias=True),
             Epilogue(activation="square", bias=True, binary="mul_silu")]


def _operands(kind, epi, dtype, seed=0):
    r = np.random.default_rng(seed)
    g, m, k, n = (1, 20, 24, 12) if kind == "plain" else (3, 10, 24, 12)
    shape_x = (m, k) if kind == "plain" else (g, m, k)
    shape_w = (k, n) if kind == "plain" else (g, k, n)
    t = lambda shape: torch.tensor(r.normal(size=shape), dtype=torch.float32).to(dtype)
    ops = {"x": t(shape_x), "w": t(shape_w)}
    if epi.bias:
        ops["bias"] = t((n,) if kind == "plain" else (g, n))
    if epi.binary != "none":
        ops["operand"] = t(shape_x[:-1] + (n,))
    return ops


def _grads_of(kind, epi, ops, backend, fused=True):
    leaves = {k: v.clone().requires_grad_(True) for k, v in ops.items()}
    kw = dict(epilogue=epi, bias=leaves.get("bias"), operand=leaves.get("operand"))
    with gemm_context(backend=backend, device="cpu"):
        if kind == "plain":
            out = gemm(leaves["x"], leaves["w"], **kw)
        elif kind == "grouped":
            out = gemm_grouped(leaves["x"], leaves["w"], fused=fused, **kw)
        else:
            out = gemm_batched(leaves["x"], leaves["w"], **kw)
    dout = torch.linspace(-1, 1, out.numel()).reshape(out.shape).to(out.dtype)
    out.backward(dout)
    return out.detach(), {k: v.grad for k, v in leaves.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["plain", "grouped", "grouped_loop", "batched"])
@pytest.mark.parametrize("epi", EPILOGUES, ids=lambda e: e.name)
def test_gemm_grad_equals_autograd_through_the_torch_backend(epi, kind, dtype):
    base = "grouped" if kind == "grouped_loop" else kind
    ops = _operands(base, epi, dtype)
    fused = kind != "grouped_loop"
    out, got = _grads_of(base, epi, ops, "cuda", fused=fused)
    with torch.no_grad(), gemm_context(backend="cuda", device="cpu"):
        kw = dict(epilogue=epi, bias=ops.get("bias"), operand=ops.get("operand"))
        fn = {"plain": gemm, "batched": gemm_batched}.get(
            base, functools.partial(gemm_grouped, fused=fused))
        no_grad_out = fn(ops["x"], ops["w"], **kw)
    assert torch.equal(out, no_grad_out)  # the forward's bits do not move
    _, want = _grads_of(base, epi, ops, "torch")
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for name, ref in want.items():
        assert got[name] is not None, name
        assert got[name].dtype == ref.dtype, name
        scale = max(ref.abs().max().item(), 1e-30)
        err = (got[name].float() - ref.float()).abs().max().item()
        assert err <= tol * scale, (name, err, scale)


@pytest.mark.parametrize("activation", ["relu", "square"])
def test_relu_and_square_gradients_at_zero_match_repro(activation):
    """An accumulator of exact zeros (a zero row of X): the derivative there
    is ``repro``'s, half the gradient for relu (``jnp.maximum``), 0 for the
    square."""
    r = np.random.default_rng(5)
    x = r.normal(size=(6, 8)).astype(np.float32)
    x[2] = 0.0
    w = r.normal(size=(8, 5)).astype(np.float32)
    dout = r.normal(size=(6, 5)).astype(np.float32)

    def j_fn(x, w):
        acc = x @ w
        return jnp.sum(JEpilogue(activation=activation).apply(acc) * dout)

    jdx, jdw = jax.grad(j_fn, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    for backend in ("torch", "cuda"):
        tx, tw = torch.tensor(x, requires_grad=True), torch.tensor(w, requires_grad=True)
        with gemm_context(backend=backend, device="cpu"):
            out = gemm(tx, tw, epilogue=activation)
        out.backward(torch.tensor(dout))
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=1e-5, atol=1e-6)


def test_a_dispatch_without_grad_never_enters_the_function(monkeypatch):
    calls = []
    real = gemm_mod.GemmGrad.apply
    monkeypatch.setattr(gemm_mod.GemmGrad, "apply",
                        lambda *a: calls.append(1) or real(*a))
    x, w = torch.randn(4, 16), torch.randn(16, 8)
    with gemm_context(backend="cuda", device="cpu"):
        out = gemm(x, w)  # grad enabled, nothing requires grad
        assert out.grad_fn is None
        wg = w.clone().requires_grad_(True)
        with torch.no_grad():
            assert gemm(x, wg).grad_fn is None
        assert not calls
        assert gemm(x, wg).grad_fn is not None
        assert calls == [1]
    with gemm_context(backend="torch", device="cpu"):
        gemm(x, wg)  # the torch backend is differentiated by autograd itself
    assert calls == [1]


def test_a_quantized_weight_under_grad_is_refused():
    x = torch.randn(4, 16, requires_grad=True)
    qw = quantize_weight(torch.randn(16, 8))
    for backend in ("torch", "cuda"):
        with gemm_context(backend=backend, device="cpu"):
            with pytest.raises(NotImplementedError, match="dense weights only"):
                gemm(x, qw)
            with torch.no_grad():
                assert gemm(x, qw).shape == (4, 8)
