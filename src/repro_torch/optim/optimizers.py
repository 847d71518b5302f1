"""Optimizers (the port's copy of ``repro.optim.optimizers``).

Every optimizer keeps f32 master weights beside the parameters, whatever
their dtype, and its state is a plain tree mirroring the parameter tree
under ``repro``'s keys (``mu``/``nu``/``master``/``count`` for AdamW,
``vel``/``master``/``count`` for SGD, ``v``/``master``/``count`` for
Adafactor), so a checkpoint carries across either way.

The math is ``repro``'s, leaf for leaf: the gradients clipped to a global
norm in f32, bias-corrected moments, weight decay on the master, and
Adafactor's factored second moments with update clipping. Where ``repro``
returns new trees, ``update`` writes in place under ``torch.no_grad()``:
each moment, then the master, then ``param.copy_(master)`` (cast to the
parameter's dtype), one leaf at a time. The card then holds one copy of
each tree, and the clipped f32 gradient of one leaf at a time rather than
of all of them. ``update`` returns (params, state, metrics), the same
objects it was given, so callers read it as they read ``repro``'s.
``update(..., norm=)`` takes the global norm from the caller: across ranks
the train step sums it over the shards
(:func:`~repro_torch.dist.collectives.global_norm`), and AdamW and SGD then
update each local shard as they would the whole leaf. Adafactor's
moments are means over dims a mesh axis may split, and its update's RMS a
mean over the whole leaf: across ranks (``update(..., plan=, specs=)``)
each is a local sum, all-reduced over the axes that split the reduced dims
and divided by the whole leaf's size, every leaf's sums of one stage in one
all-reduce per set of axes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch

from repro_torch.dist.collectives import mesh_axis, raw_all_reduce
from repro_torch.dist.sharding import axes_of, spec_items
from repro_torch.utils.trees import tree_global_norm, tree_items, tree_map

Schedule = Callable[[Any], torch.Tensor]


def _clip_scale(grads, max_norm: float, norm=None):
    if norm is None:
        norm = tree_global_norm(grads)
    return torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0), norm


def clip_by_global_norm(grads, max_norm: float):
    """(every gradient in f32 times ``min(1, max_norm / norm)``, the global
    norm), as ``repro``'s. The optimizers apply the same scale leaf by leaf."""
    scale, norm = _clip_scale(grads, max_norm)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), norm


def _f32_copy(p: torch.Tensor) -> torch.Tensor:
    return p.detach().to(torch.float32, copy=True)


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _count() -> torch.Tensor:
    # the step counter lives on the host, a 0-d int32 as in repro's state;
    # a 0-d CPU tensor combines with device tensors as a scalar
    return torch.zeros((), dtype=torch.int32)


def _leaf_triples(grads, state_key_trees, params):
    """(name, grad, [state leaf of each tree], param) in tree order."""
    g_items = dict(tree_items(grads))
    others = [dict(tree_items(t)) for t in state_key_trees]
    for name, p in tree_items(params):
        yield name, g_items[name], [o[name] for o in others], p


def _step_count(state):
    count = state["count"] + 1
    state["count"] = count
    return count


@dataclass(frozen=True)
class AdamW:
    schedule: Schedule
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0

    def init(self, params) -> Dict[str, Any]:
        return {
            "mu": tree_map(_zeros_f32, params),
            "nu": tree_map(_zeros_f32, params),
            "master": tree_map(_f32_copy, params),
            "count": _count(),
        }

    @torch.no_grad()
    def update(self, grads, state, params, norm=None):
        scale, gnorm = _clip_scale(grads, self.max_grad_norm, norm)
        count = _step_count(state)
        lr = self.schedule(count)
        cf = count.to(torch.float32)
        b1c = 1 - torch.pow(torch.tensor(self.b1, dtype=torch.float32), cf)
        b2c = 1 - torch.pow(torch.tensor(self.b2, dtype=torch.float32), cf)
        for _, g, (m, v, master), p in _leaf_triples(
            grads, (state["mu"], state["nu"], state["master"]), params
        ):
            g = g.to(torch.float32) * scale
            m.copy_(self.b1 * m + (1 - self.b1) * g)
            v.copy_(self.b2 * v + (1 - self.b2) * torch.square(g))
            del g
            upd = (m / b1c) / (torch.sqrt(v / b2c) + self.eps)
            upd = upd + self.weight_decay * master
            master.copy_(master - lr * upd)
            del upd
            p.copy_(master)
        return params, state, {"grad_norm": gnorm, "lr": lr}


@dataclass(frozen=True)
class SGD:
    schedule: Schedule
    momentum: float = 0.9
    max_grad_norm: float = 1.0

    def init(self, params):
        return {
            "vel": tree_map(_zeros_f32, params),
            "master": tree_map(_f32_copy, params),
            "count": _count(),
        }

    @torch.no_grad()
    def update(self, grads, state, params, norm=None):
        scale, gnorm = _clip_scale(grads, self.max_grad_norm, norm)
        count = _step_count(state)
        lr = self.schedule(count)
        for _, g, (vel, master), p in _leaf_triples(
            grads, (state["vel"], state["master"]), params
        ):
            vel.copy_(self.momentum * vel + g.to(torch.float32) * scale)
            master.copy_(master - lr * vel)
            p.copy_(master)
        return params, state, {"grad_norm": gnorm, "lr": lr}


@dataclass(frozen=True)
class Adafactor:
    """Factored second moments (Shazeer & Stern): O(m + n) state per (m, n)
    matrix instead of O(mn)."""

    schedule: Schedule
    eps: float = 1e-30
    clip_threshold: float = 1.0
    max_grad_norm: float = 1.0

    def init(self, params):
        def factored(p):
            if p.dim() >= 2:
                return {
                    "vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                      device=p.device),
                }
            return {"v": _zeros_f32(p)}

        return {
            "v": tree_map(factored, params),
            "master": tree_map(_f32_copy, params),
            "count": _count(),
        }

    @torch.no_grad()
    def update(self, grads, state, params, norm=None, plan=None, specs=None):
        """One step; ``plan``/``specs`` (a ranked plan, the parameters'
        ArraySpec tree): ``params`` are this rank's shards (module doc)."""
        scale, gnorm = _clip_scale(grads, self.max_grad_norm, norm)
        count = _step_count(state)
        lr = self.schedule(count)
        decay = 1.0 - torch.pow(count.to(torch.float32), -0.8)
        if plan is not None:
            self._ranked_update(grads, state, params, scale, lr, decay, plan, specs)
            return params, state, {"grad_norm": gnorm, "lr": lr}
        g_items = dict(tree_items(grads))
        m_items = dict(tree_items(state["master"]))
        v_tree = state["v"]
        for name, p in tree_items(params):
            g = g_items[name].to(torch.float32) * scale
            master = m_items[name]
            v = v_tree
            for key in name.split("/"):
                v = v[key]
            g2 = torch.square(g) + self.eps
            if g.dim() >= 2:
                v["vr"].copy_(decay * v["vr"] + (1 - decay) * torch.mean(g2, dim=-1))
                v["vc"].copy_(decay * v["vc"] + (1 - decay) * torch.mean(g2, dim=-2))
                denom = torch.clamp_min(torch.mean(v["vr"], dim=-1, keepdim=True), self.eps)
                vhat = v["vr"][..., None] * v["vc"][..., None, :] / denom[..., None]
            else:
                v["v"].copy_(decay * v["v"] + (1 - decay) * g2)
                vhat = v["v"]
            u = g / torch.sqrt(vhat + self.eps)
            rms = torch.sqrt(torch.mean(torch.square(u)) + self.eps)
            u = u / torch.clamp_min(rms / self.clip_threshold, 1.0)
            master.copy_(master - lr * u)
            p.copy_(master)
        return params, state, {"grad_norm": gnorm, "lr": lr}

    def _ranked_update(self, grads, state, params, scale, lr, decay, plan, specs):
        """The update of local shards (module doc), in four stages over all
        leaves: the moments' sums, ``vr``'s mean for the denominator, the
        update's sum of squares, then the update itself (``u`` made anew,
        so one leaf's f32 update is held at a time)."""
        flat = dict(spec_items(specs))
        g_items = dict(tree_items(grads))
        m_items = dict(tree_items(state["master"]))
        leaves = []
        for name, p in tree_items(params):
            v = state["v"]
            for key in name.split("/"):
                v = v[key]
            spec = flat[name]
            dims = [tuple(a for a in axes_of(part) if mesh_axis(a, plan.mesh) is not None)
                    for part in plan.spec_for(spec)]
            leaves.append((name, p, m_items[name], v, spec, dims))

        def grad(name):
            return g_items[name].to(torch.float32) * scale

        # the moments: vr the mean over the last dim, vc over dim -2
        sums = []
        for name, _, _, v, spec, dims in leaves:
            g2 = torch.square(grad(name)) + self.eps
            if g2.dim() >= 2:
                sums += [(g2.sum(dim=-1), dims[-1]), (g2.sum(dim=-2), dims[-2])]
        sums = iter(_sum_over(plan, sums))
        for _, _, _, v, spec, dims in leaves:
            if len(spec.shape) >= 2:
                v["vr"].copy_(decay * v["vr"] + (1 - decay) * next(sums) / spec.shape[-1])
                v["vc"].copy_(decay * v["vc"] + (1 - decay) * next(sums) / spec.shape[-2])
        # the denominators: vr's mean over its last dim (the leaf's dim -2)
        denoms = iter(_sum_over(plan, [(v["vr"].sum(dim=-1, keepdim=True), dims[-2])
                                       for _, _, _, v, spec, dims in leaves
                                       if len(spec.shape) >= 2]))

        def update_of(name, v, spec, denom):
            g = grad(name)
            if g.dim() >= 2:
                vhat = v["vr"][..., None] * v["vc"][..., None, :] / denom[..., None]
            else:
                v["v"].copy_(decay * v["v"] + (1 - decay) * (torch.square(g) + self.eps))
                vhat = v["v"]
            return g / torch.sqrt(vhat + self.eps)

        denom_of = {}
        squares = []
        for name, _, _, v, spec, dims in leaves:
            if len(spec.shape) >= 2:
                denom_of[name] = torch.clamp_min(next(denoms) / spec.shape[-2], self.eps)
            u = update_of(name, v, spec, denom_of.get(name))
            squares.append((torch.sum(torch.square(u)).reshape(1),
                            tuple(a for d in dims for a in d)))
        squares = _sum_over(plan, squares)
        for (name, p, master, v, spec, _), sq in zip(leaves, squares):
            if len(spec.shape) < 2:  # its moment was updated above
                g = grad(name)
                u = g / torch.sqrt(v["v"] + self.eps)
            else:
                u = update_of(name, v, spec, denom_of[name])
            rms = torch.sqrt(sq[0] / math.prod(spec.shape) + self.eps)
            u = u / torch.clamp_min(rms / self.clip_threshold, 1.0)
            master.copy_(master - lr * u)
            p.copy_(master)


def _sum_over(plan, parts):
    """Each (tensor, mesh axes) of ``parts`` summed over its axes, the
    tensors that share a set of axes flattened into one all-reduce per
    axis; returns the sums in order."""
    out = [t for t, _ in parts]
    groups: Dict[tuple, list] = {}
    for i, (_, axes) in enumerate(parts):
        if axes:
            groups.setdefault(axes, []).append(i)
    for axes, idx in groups.items():
        flat = torch.cat([parts[i][0].reshape(-1) for i in idx])
        for a in axes:
            flat = raw_all_reduce(flat, mesh_axis(a, plan.mesh))
        start = 0
        for i in idx:
            n = parts[i][0].numel()
            out[i] = flat[start:start + n].reshape(parts[i][0].shape)
            start += n
    return out


def make_optimizer(name: str, schedule: Schedule, **kw):
    name = name.lower()
    if name == "adamw":
        return AdamW(schedule, **kw)
    if name == "sgd":
        return SGD(schedule, **kw)
    if name == "adafactor":
        return Adafactor(schedule, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
