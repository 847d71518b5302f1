"""Logical-axis sharding (the counterpart of ``repro.dist.sharding``):
ArraySpec trees -> per-array partition entries via named rules.

Model code never names mesh axes. Parameters and activations carry *logical*
axis names (``"embed"``, ``"heads"``, ``"batch"``, ...) in ``ArraySpec``s;
a :class:`ShardingPlan` binds those names to the axes of a mesh through a
rule table (``DEFAULT_RULES`` + per-cell overrides). The mesh is any object
with an ordered ``shape`` mapping (axis name -> size) and ``axis_names``
(``repro_torch.launch.mesh`` makes device-free ones), so the solver runs
without devices. It demotes an axis to replication when

  * the rule maps to mesh axes absent from this mesh (e.g. ``pod`` on a
    single-pod mesh),
  * every mapped mesh axis has size 1 (sharding would be a no-op),
  * the dim is not divisible by the mapped axis product (it would pad), or
  * a mesh axis was already consumed by an earlier dim of the same array
    (an axis may shard at most one dim).

:meth:`ShardingPlan.spec_for` gives an array's partition entries as a plain
tuple (``None``, an axis name, or a tuple of names: the entries of
``repro``'s ``PartitionSpec``); :func:`placements_for` turns them into DTensor
``Shard``/``Replicate`` placements for a ``DeviceMesh``.

``constrain``/``constrain_uneven`` are the activation-side hints. The plan
is thread-local (:func:`use_plan`); without one they return their input
untouched, and under one they check the hint against the array (its rank)
and return the array as it is: on one rank every array is whole, and the
multi-rank step that would lay activations out by them is a later slice.
"""

from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.core.gemm import as_dtype

#: logical axis -> mesh axis (or tuple of mesh axes, outermost first).
#: ``batch`` spans the pure data-parallel axes; tensor-parallel dims ride
#: ``model``; ``embed`` is FSDP-sharded over ``data``.
DEFAULT_RULES: Dict[str, Any] = {
    "batch": ("pod", "data"),
    "embed": "data",
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "vocab": "model",
    "experts": "model",
    "ssm_inner": "model",
    "frames": None,
    "seq": None,
    "kv_seq": None,
    "stack": None,
}

#: one partition entry: replicated, one mesh axis, or several (outermost first)
Entry = Optional[Any]


@dataclass
class ArraySpec:
    """Shape + dtype + logical sharding axes (+ init) for one array."""

    shape: Tuple[int, ...]
    dtype: str = "float32"
    axes: Tuple[Optional[str], ...] = ()
    init: str = "normal"  # "normal" | "zeros" | "ones"

    def __post_init__(self):
        self.shape = tuple(int(d) for d in self.shape)
        self.axes = tuple(self.axes)
        if len(self.axes) != len(self.shape):
            raise ValueError(f"axes/shape rank mismatch: {self.axes} vs {self.shape}")

    def abstract(self) -> torch.Tensor:
        """A meta tensor of this shape and dtype (no storage)."""
        return torch.empty(self.shape, dtype=spec_dtype(self.dtype), device="meta")


def spec_dtype(name: str) -> torch.dtype:
    """The torch dtype a spec's dtype name stands for (the model dtypes,
    ``int8`` and ``int32`` among them)."""
    return getattr(torch, name) if name in ("int8", "int32", "int64") else as_dtype(name)


def spec_items(tree, prefix: str = ""):
    """(path, ArraySpec) of every leaf, dict keys sorted (``jax.tree``'s
    order, so lists made from it match ``repro``'s)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from spec_items(tree[key], f"{prefix}{key}/")
    else:
        yield prefix[:-1], tree


def _map_specs(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return fn(tree)


class ShardingPlan:
    """Binds logical axis names to the axes of a mesh (see module doc)."""

    def __init__(self, mesh, rules: Optional[Mapping[str, Any]] = None):
        self.mesh = mesh
        self.rules: Dict[str, Any] = dict(DEFAULT_RULES)
        if rules:
            self.rules.update(rules)

    # -- solving -----------------------------------------------------------
    def _mesh_axes_for(self, logical: Optional[str]) -> Tuple[str, ...]:
        """Mesh axes (present in this mesh, size > 1) a logical axis maps to."""
        if logical is None:
            return ()
        rule = self.rules.get(logical)
        if rule is None:
            return ()
        names = (rule,) if isinstance(rule, str) else tuple(rule)
        return tuple(a for a in names if a in self.mesh.shape and self.mesh.shape[a] > 1)

    def axis_divisor(self, logical: str) -> int:
        """Sharding factor a logical axis implies on this mesh."""
        return math.prod((self.mesh.shape[a] for a in self._mesh_axes_for(logical)), start=1)

    def gemm_div(self) -> Dict[str, int]:
        """Per-shard GEMM divisor table for this mesh: the ``div`` dict the
        model layers thread into dispatch. Tokens shard over the batch axes
        (``pod`` x ``data``); tensor-parallel weight dims ride the mesh's
        ``model`` axis. Dividing the global MNK by these makes a
        :class:`~repro_torch.core.op.GemmOp` fingerprint the per-shard
        problem one device runs, so a tuning record made on one host is a
        database hit on every identically sharded host.

        Mesh-level: it does not see :meth:`spec_for`'s per-array
        divisibility demotion. The serve and train tables
        (``serve_gemm_div``, ``train_gemm_div``) probe :meth:`demoted_dims`
        and demote it where a weight dim would run replicated."""
        return {
            "batch": self.axis_divisor("batch"),
            "model": int(self.mesh.shape.get("model", 1)),
        }

    def demoted_dims(self, specs, mesh_axis: str = "model"):
        """Every (shape, axes, dim_index, dim) in the ArraySpec tree whose
        logical axis maps onto ``mesh_axis`` but which :meth:`spec_for`
        would demote to replication (a dim not divisible by its axes).
        Empty means :meth:`gemm_div`'s entry for that axis is exact for
        every array in the tree."""
        out = []
        for _, s in spec_items(specs):
            used: set = set()
            for i, (dim, logical) in enumerate(zip(s.shape, s.axes)):
                axes = tuple(a for a in self._mesh_axes_for(logical) if a not in used)
                if not axes:
                    continue
                div = math.prod(self.mesh.shape[a] for a in axes)
                if dim % div:
                    if mesh_axis in axes:
                        out.append((s.shape, s.axes, i, dim))
                else:
                    used.update(axes)
        return out

    def spec_for(self, spec: ArraySpec, *, uneven: bool = False) -> Tuple[Entry, ...]:
        """Partition entries for one array, with demotion (module doc)."""
        used: set = set()
        entries = []
        for dim, logical in zip(spec.shape, spec.axes):
            axes = tuple(a for a in self._mesh_axes_for(logical) if a not in used)
            if axes:
                div = math.prod(self.mesh.shape[a] for a in axes)
                if not uneven and dim % div:
                    axes = ()
            used.update(axes)
            if not axes:
                entries.append(None)
            elif len(axes) == 1:
                entries.append(axes[0])
            else:
                entries.append(axes)
        return tuple(entries)

    def local_shape(self, spec: ArraySpec) -> Tuple[int, ...]:
        """The shape of one shard of the array (every dim divides exactly:
        :meth:`spec_for` demotes the dims that would not)."""
        out = []
        for dim, part in zip(spec.shape, self.spec_for(spec)):
            axes = () if part is None else ((part,) if isinstance(part, str) else part)
            out.append(dim // math.prod((self.mesh.shape[a] for a in axes), start=1))
        return tuple(out)


def placements_for(pspec: Sequence[Entry], device_mesh) -> Tuple[Any, ...]:
    """DTensor placements of partition entries ``pspec`` (:meth:`ShardingPlan.spec_for`)
    on ``device_mesh``, one per mesh dim in its order: ``Shard(i)`` where
    tensor dim ``i`` rides that mesh axis, else ``Replicate()``. The mesh is
    a ``torch.distributed.device_mesh.DeviceMesh`` (its
    ``mesh_dim_names``) or anything with ``axis_names``."""
    from torch.distributed.tensor import Replicate, Shard

    names = getattr(device_mesh, "mesh_dim_names", None) or device_mesh.axis_names
    dim_of: Dict[str, int] = {}
    for i, part in enumerate(pspec):
        for axis in () if part is None else ((part,) if isinstance(part, str) else part):
            dim_of[axis] = i
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate() for a in names)


# -- ambient plan -----------------------------------------------------------

_plan_state = threading.local()


def current_plan() -> Optional[ShardingPlan]:
    """The calling thread's installed plan, or None."""
    return getattr(_plan_state, "plan", None)


@contextmanager
def use_plan(plan: Optional[ShardingPlan]):
    """Install ``plan`` on the calling thread for the block (None clears it)."""
    old = current_plan()
    _plan_state.plan = plan
    try:
        yield plan
    finally:
        _plan_state.plan = old


def _constrain(x: torch.Tensor, axes: Sequence[Optional[str]], uneven: bool) -> torch.Tensor:
    plan = current_plan()
    if plan is not None:
        # the hint's own check (rank, rules); one rank holds every array whole
        plan.spec_for(ArraySpec(tuple(x.shape), "float32", tuple(axes)), uneven=uneven)
    return x


def constrain(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Sharding hint by logical axis names; ``x`` itself on one rank."""
    return _constrain(x, axes, uneven=False)


def constrain_uneven(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Like :func:`constrain` but keeps axes whose dim is not divisible
    (the layout pads, e.g. 56 heads over a 16-way model axis)."""
    return _constrain(x, axes, uneven=True)


# -- materialization ---------------------------------------------------------


def abstract_tree(tree):
    """ArraySpec tree -> tree of meta tensors (shapes and dtypes, no
    storage: what the dry run traces)."""
    return _map_specs(lambda s: s.abstract(), tree)


def init_leaf(spec: ArraySpec, generator: torch.Generator, device) -> torch.Tensor:
    """Materialise one spec as ``repro``'s ``_init_leaf`` does: zeros, ones,
    or a fan-in-scaled normal (the second-to-last dim is the fan-in, so a
    leading stacked-layer axis never counts). Stacked leaves are drawn one
    layer at a time, so the f32 draw never holds more than one layer."""
    dtype = spec_dtype(spec.dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    std = 1.0 / math.sqrt(max(1, fan_in))
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    for part in out.reshape(-1, *spec.shape[-2:]) if len(spec.shape) > 2 else (out,):
        draw = torch.randn(part.shape, generator=generator, device=device)
        part.copy_(draw * std)
    return out


def materialize_tree(tree, generator: torch.Generator, device):
    """Instantiate an ArraySpec tree leaf by leaf (:func:`init_leaf`), every
    draw from ``generator`` in the tree's order."""
    return _map_specs(lambda s: init_leaf(s, generator, device), tree)
