"""GPipe pipeline parallelism (the counterpart of ``repro.dist.pipeline``).

``split_stages`` folds the stacked-layer axis (L, ...) into (S, L/S, ...).
``pipeline_apply`` runs the GPipe schedule: microbatch ``m`` is processed by
stage ``s`` at step ``s + m``; activations move one stage forward a step, so
the whole batch drains in ``M + S - 1`` steps.

Two executions of the same schedule:

* **ranked** (a ``torch.distributed`` process group is initialised and its
  size divides the stage count): each rank owns a contiguous block of
  stages and moves activations to the next rank with point-to-point
  ``send``/``recv`` (``repro``'s ``ppermute`` ring); the last rank's
  finished microbatches are broadcast to every rank (``repro`` sums them
  with ``psum``).
* **local** (no process group): a rotating buffer of one activation per
  stage; each step every stage holding a microbatch advances it.

Both are exactly equal to applying the stages in order, microbatch by
microbatch: the same operations on the same values.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.utils.trees import tree_leaves, tree_map


def split_stages(params, n_stages: int):
    """(L, ...) stacked params -> (S, L/S, ...) staged params (views)."""

    def split(a):
        n = a.shape[0]
        assert n % n_stages == 0, f"{n} layers not divisible into {n_stages} stages"
        return a.reshape(n_stages, n // n_stages, *a.shape[1:])

    return tree_map(split, params)


def _stage(stage_params, i: int):
    return tree_map(lambda a: a[i], stage_params)


def _pipeline_local(stage_fn, stage_params, x):
    """One process: the rotating buffer. ``buf[i]`` holds the activation
    stage ``i`` produced last step; at step ``t`` stage ``i`` takes
    microbatch ``t - i`` from stage ``i - 1`` (stage 0 from ``x``)."""
    s = tree_leaves(stage_params)[0].shape[0]
    m = x.shape[0]
    buf = [None] * s
    outs = torch.empty_like(x)
    for t in range(m + s - 1):
        shifted = [x[t] if t < m else None] + buf[:-1]
        buf = [stage_fn(_stage(stage_params, i), h) if 0 <= t - i < m else None
               for i, h in enumerate(shifted)]
        if t >= s - 1:
            outs[t - (s - 1)] = buf[-1]
    return outs


def _pipeline_ranked(stage_fn, stage_params, x, group):
    """Across the ranks of ``group``: rank ``j`` runs stages ``[j * S/n,
    (j + 1) * S/n)`` on each microbatch in turn, receiving it from rank
    ``j - 1`` and sending it on to rank ``j + 1``."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    j = dist.get_rank(group)
    s = tree_leaves(stage_params)[0].shape[0]
    s_loc = s // n
    ranks = dist.get_process_group_ranks(group) if group is not None else list(range(n))
    outs = torch.empty_like(x)
    for mb in range(x.shape[0]):
        if j == 0:
            h = x[mb]
        else:
            h = torch.empty_like(x[mb])
            dist.recv(h, src=ranks[j - 1], group=group)
        for i in range(j * s_loc, (j + 1) * s_loc):
            h = stage_fn(_stage(stage_params, i), h)
        if j < n - 1:
            dist.send(h.contiguous(), dst=ranks[j + 1], group=group)
        else:
            outs[mb] = h
    dist.broadcast(outs, src=ranks[n - 1], group=group)
    return outs


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params,
    x: torch.Tensor,  # (M, MB, ...) microbatches
    *,
    group=None,
):
    """Run ``stage_fn`` over all stages in GPipe order; returns (M, MB, ...).
    ``stage_params`` holds every stage (S, ...) on every rank; ranked when a
    process group is initialised (``group``, default the world) whose size
    divides S, local otherwise."""
    import torch.distributed as dist

    s = tree_leaves(stage_params)[0].shape[0]
    if dist.is_available() and dist.is_initialized():
        n = dist.get_world_size(group)
        if n > 1 and s % n == 0:
            return _pipeline_ranked(stage_fn, stage_params, x, group)
    return _pipeline_local(stage_fn, stage_params, x)
