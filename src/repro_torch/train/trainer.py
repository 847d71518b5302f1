"""Fault-tolerant training loop (the port's counterpart of
``repro.train.trainer``).

Beyond the train step itself:
  * checkpoint/restart (exact resume: params + optimizer + data-iterator +
    step; ``repro``'s layout, so a ``repro`` checkpoint resumes here),
  * preemption (SIGTERM -> final checkpoint),
  * straggler monitoring (per-step wall-time EWMA; steps > mean + k*sigma are
    logged and counted), timed with the device synchronised,
  * microbatch gradient accumulation in f32 buffers (``repro``'s scan adds
    each microbatch's gradient into f32 zeros; a bf16 ``.grad`` would round
    at every microbatch),
  * optional int8 gradient compression with error feedback
    (``dist/compression.py``),
  * simulated failure injection for the fault-tolerance tests,
  * any (data, model) factorisation of the ranks under a ranked plan
    (:func:`~repro_torch.dist.sharding.ranked_plan`): the batch rows split
    over the data axes, each rank runs the tensor- and FSDP-parallel step on
    its shards, the gradients of leaves not sharded over a data axis are
    summed over it (and, in a sequence-parallel step, the norms' over
    ``model``), the global norm is summed across ranks, and the optimizer
    updates the local shards (Adafactor reducing its factored moments
    across them). Checkpoints hold full leaves, so a run resumes on another
    factorisation (``repro``'s elastic contract).

The step is eager PyTorch: the loss and its gradients through autograd,
every projection on the selected backend (on the card the hand-written
kernels forward, :class:`~repro_torch.core.gemm.GemmGrad` backward), then
the optimizer's in-place update. The state is ``{"params", "opt", "step"}``
(+ ``"ef"`` with compression) as in ``repro``, with ``step`` a 0-d int32 on
the host; the parameter leaves require grad.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, install_sigterm_handler
from repro_torch.data import SyntheticLMData
from repro_torch.dist.collectives import all_reduce_axes, global_norm, sync_grads
from repro_torch.dist.compression import ErrorFeedback
from repro_torch.dist.sharding import batch_axes, local_rows, ranked_plan
from repro_torch.optim.optimizers import Adafactor
from repro_torch.utils.logging import get_logger
from repro_torch.utils.timing import EWMA, Timer
from repro_torch.utils.trees import tree_items, tree_map

log = get_logger("train")


def train_gemm_div(model, batch: Optional[int] = None, plan=None) -> Dict[str, int]:
    """The GEMM divisor table of the train path (``repro``'s
    ``train_gemm_div``): the plan's :meth:`ShardingPlan.gemm_div`, with its
    ``model`` entry demoted to 1 when any weight dim that rides ``model``
    would run replicated under the plan's own solver (``demoted_dims``),
    and its ``batch`` entry demoted to 1 when the global ``batch`` does not
    divide, so train fingerprints never claim splits the arrays do not
    run at. ``plan`` defaults to the installed one
    (:func:`~repro_torch.dist.sharding.current_plan`); ``{}`` without a plan
    (unsharded training) and under a ranked one (local tensors)."""
    from repro_torch.dist.sharding import current_plan, ranked_plan

    if plan is None:
        plan = current_plan()
    if plan is None or ranked_plan(plan) is not None:
        # a ranked plan's tensors are already local: unit divisors
        return {}
    div = dict(plan.gemm_div())
    tp = div.get("model", 1)
    if tp > 1:
        offenders = plan.demoted_dims(model.param_specs(), mesh_axis="model")
        if offenders:
            shown = ", ".join(f"dim {d} ({ax or '?'}) of {sh}" for sh, ax, _, d in offenders[:3])
            log.warning(
                "train fingerprints demote model divisor %d -> 1: %d weight dim(s) fail the "
                "plan's divisibility solver and run replicated (e.g. %s)",
                tp, len(offenders), shown,
            )
            div["model"] = 1
    db = div.get("batch", 1)
    if batch is not None and db > 1 and batch % db:
        log.warning(
            "train fingerprints demote batch divisor %d -> 1: global batch %d is not "
            "divisible, so activations run replicated", db, batch,
        )
        div["batch"] = 1
    return div


@dataclass
class TrainerConfig:
    total_steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    ckpt_keep: int = 3
    async_ckpt: bool = True
    microbatches: int = 1
    grad_compression: bool = False
    straggler_k: float = 3.0
    handle_sigterm: bool = False


def to_device_batch(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A host batch (numpy) as tensors on ``device``: integer arrays as
    int64 (tokens and labels index the embedding), the rest as they are."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = (t.long() if t.dtype in (torch.int32, torch.int64) else t).to(device)
    return out


def params_device(params) -> torch.device:
    """The device of a parameter tree (its first leaf's)."""
    return next(leaf for _, leaf in tree_items(params)).device


def _require_grads(params):
    for _, p in tree_items(params):
        if p.is_floating_point() and not p.requires_grad:
            p.requires_grad_(True)


def take_grads(params):
    """The tree of each leaf's ``.grad``, the leaves' ``.grad`` cleared;
    raises naming every leaf the loss gave no gradient (a dispatch that left
    the graph would otherwise train silently without it)."""
    missing = [name for name, p in tree_items(params) if p.grad is None]
    if missing:
        raise RuntimeError(f"no gradient reached {len(missing)} parameter leaves: {missing[:8]}")

    def take(p):
        g = p.grad
        p.grad = None
        return g

    return tree_map(take, params)


def make_train_step(
    model,
    optimizer,
    *,
    div: Optional[Dict[str, int]] = None,
    microbatches: int = 1,
    grad_compression: bool = False,
):
    """Build the train step: (state, batch) -> (state, metrics), ``batch`` a
    dict of tensors on the parameters' device. The state is updated in
    place and returned. With ``microbatches > 1`` the batch is split on
    axis 0 and the gradients are summed in f32 buffers, then divided (the
    loss is the microbatches' mean, the metrics the last one's). Under a
    ranked plan ``batch`` is this rank's rows (``local_rows``), and the
    returned loss is the global one (module doc)."""

    def grads_of(params, batch):
        loss, metrics = model.loss_fn(params, batch, div=div)
        loss.backward()
        return loss.detach(), metrics, take_grads(params)

    def compute_grads(params, batch):
        if microbatches == 1:
            return grads_of(params, batch)
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                       params)
        loss_sum = 0.0
        for i in range(microbatches):
            mb = {k: v.reshape(microbatches, v.shape[0] // microbatches, *v.shape[1:])[i]
                  for k, v in batch.items()}
            loss, metrics, grads = grads_of(params, mb)
            tree_map(lambda a, g: a.add_(g), acc, grads)
            del grads
            loss_sum = loss_sum + loss
        return loss_sum / microbatches, metrics, tree_map(lambda a: a.div_(microbatches), acc)

    def step_fn(state, batch):
        params = state["params"]
        _require_grads(params)
        loss, metrics, grads = compute_grads(params, batch)
        plan = ranked_plan()
        norm = None
        ranked = {}
        if plan is not None:
            specs = model.param_specs()
            grads = sync_grads(grads, specs, plan, model.seq_parallel_leaves(batch))
            norm = global_norm(grads, specs, plan)
            loss = all_reduce_axes(loss, batch_axes(plan))
            if isinstance(optimizer, Adafactor):
                ranked = {"plan": plan, "specs": specs}
        if grad_compression:
            grads, state["ef"] = ErrorFeedback.apply(grads, state["ef"])
        _, _, opt_metrics = optimizer.update(grads, state["opt"], params, norm=norm, **ranked)
        state["step"] = state["step"] + 1
        return state, {**metrics, **opt_metrics, "loss": loss}

    return step_fn


def init_train_state(model, optimizer, params, grad_compression: bool = False):
    """``{"params", "opt", "step"}`` (+ ``"ef"``) for ``params``, whose
    floating leaves are set to require grad."""
    _require_grads(params)
    state = {
        "params": params,
        "opt": optimizer.init(params),
        "step": torch.zeros((), dtype=torch.int32),
    }
    if grad_compression:
        state["ef"] = ErrorFeedback.init(params)
    return state


@dataclass
class StragglerMonitor:
    ewma: EWMA = field(default_factory=EWMA)
    k: float = 3.0
    flagged: int = 0

    def observe(self, seconds: float) -> bool:
        outlier = self.ewma.is_outlier(seconds, self.k)
        self.ewma.update(seconds)
        if outlier:
            self.flagged += 1
            log.warning(
                "straggler step: %.3fs (mean %.3fs, std %.3fs)",
                seconds,
                self.ewma.mean,
                self.ewma.std,
            )
        return outlier


class Trainer:
    """The training loop over ``data`` (see the module docstring)."""

    def __init__(
        self,
        model,
        optimizer,
        data: SyntheticLMData,
        cfg: TrainerConfig,
        *,
        div: Optional[Dict[str, int]] = None,
        failure_injector: Optional[Callable[[int], None]] = None,
    ):
        self.model = model
        self.optimizer = optimizer
        self.data = data
        self.cfg = cfg
        if div is None:
            div = train_gemm_div(model) or None
        self.div = div
        self.failure_injector = failure_injector
        self.step_fn = make_train_step(
            model,
            optimizer,
            div=div,
            microbatches=cfg.microbatches,
            grad_compression=cfg.grad_compression,
        )
        self.ckpt = CheckpointManager(cfg.ckpt_dir, cfg.ckpt_keep) if cfg.ckpt_dir else None
        self.monitor = StragglerMonitor(k=cfg.straggler_k)
        self.history: list = []

    # -- checkpoint plumbing ------------------------------------------------
    def _save(self, state, blocking=True):
        if not self.ckpt:
            return
        step = int(state["step"])
        self.ckpt.save(
            step,
            state,
            extra={"data": self.data.state_dict()},
            blocking=blocking,
            specs=self.model.param_specs(),
        )

    def maybe_restore(self, state):
        """(state restored from the latest checkpoint and its step), or
        (``state``, 0) without one; the data stream resumes with it."""
        if not self.ckpt or self.ckpt.latest_step() is None:
            return state, 0
        restored, step = self.ckpt.restore(state, specs=self.model.param_specs())
        _require_grads(restored["params"])
        extra = self.ckpt.read_extra(step)
        if "data" in extra:
            self.data.load_state_dict(extra["data"])
        log.info("resumed from checkpoint step %d", step)
        return restored, step

    # -- main loop --------------------------------------------------------------
    def fit(self, state):
        """Run to ``cfg.total_steps`` from ``state`` (or from the latest
        checkpoint); returns the final state, the losses in ``history``."""
        cfg = self.cfg
        state, start = self.maybe_restore(state)
        if cfg.handle_sigterm and self.ckpt:
            install_sigterm_handler(lambda: self._save(state, blocking=True))
        device = params_device(state["params"])
        step = start
        while step < cfg.total_steps:
            batch = local_rows(to_device_batch(self.data.batch_at(step), device))
            if self.failure_injector:
                self.failure_injector(step)  # may raise to simulate a crash
            with Timer(device) as t:
                state, metrics = self.step_fn(state, batch)
            self.monitor.observe(t.seconds)
            step += 1
            self.data.state.step = step
            loss = float(metrics["loss"])
            self.history.append(loss)
            if step % cfg.log_every == 0 or step == cfg.total_steps:
                log.info(
                    "step %d loss %.4f grad_norm %.3f (%.3fs)",
                    step,
                    loss,
                    float(metrics.get("grad_norm", 0.0)),
                    t.seconds,
                )
            if self.ckpt and (step % cfg.ckpt_every == 0 or step == cfg.total_steps):
                self._save(state, blocking=not cfg.async_ckpt)
        if self.ckpt:
            self.ckpt.wait()
        return state
