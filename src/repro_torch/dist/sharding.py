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
untouched, and under one they check the hint against the array and return
the array as it is. On one rank every array is whole, so the check is the
hint's own (its rank, its rules). Under a *ranked* plan (:func:`ranked_plan`:
a :class:`~repro_torch.launch.mesh.HostMesh` of more than one rank) every
array is already this rank's shard, laid out explicitly by the model code:
batch rows over the data axes, weights by :meth:`ShardingPlan.spec_for`,
a training step's residual stream over ``model`` along its sequence where
the ``seq`` rule puts it there (:func:`residual_split`), a decode cache's
positions over the ``kv_seq`` axes (:func:`kv_seq_split`), activations
otherwise whole. There the hint must describe that layout (it may shard
the batch dims over the batch axes and the sequence dims, ``seq`` and
``kv_seq``, over any axes, and nothing else) and ``x`` must be the local
shard it implies: a whole number of shards, with every sharded dim
divisible by its axes. Nothing is resharded.

:func:`shard_tree` and :func:`gather_tree` move a tree between its full
form (``repro``'s parameters through ``params_from_jax``, a checkpoint)
and one rank's local form. A
:class:`~repro_torch.core.quant.QuantizedTensor` leaf moves as its two
parts (:func:`quant_part_specs`): the values by the weight's spec (for
int4 on the packed K), the scales by it with the K entry dropped.

Batch rows split over the batch axes (:func:`batch_axes`) where those
divide the batch. A serving call whose batch they do not divide keeps its
rows whole on every rank (``repro``'s demotion): it runs under
:func:`whole_rows`, and :func:`row_axes` then names no axis, so the layers
exchange nothing over the data axes for its rows.

Sequence parallelism: a training step whose plan puts ``seq`` on
``model`` (``repro``'s ``train_4k`` rule) runs its layer stack under
:func:`seq_sharded`, and each rank holds its contiguous range of the
residual stream's positions between the blocks (``models/layers.py``).
"""

from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.core.gemm import as_dtype
from repro_torch.core.quant import QuantizedTensor, is_quantized

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


def ranked_plan(plan: Optional[ShardingPlan] = None) -> Optional[ShardingPlan]:
    """``plan`` (default: the installed one) when its mesh spans more than
    one rank (real or virtual), else None: the layers then run on local
    shards with unit GEMM divisors and explicit collectives."""
    plan = current_plan() if plan is None else plan
    if plan is not None and getattr(plan.mesh, "ranked", False):
        return plan
    return None


def axes_of(entry: Entry) -> Tuple[str, ...]:
    """The mesh axes of one partition entry, outermost first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def batch_axes(plan: ShardingPlan) -> Tuple[str, ...]:
    """The mesh axes (present, size > 1) the ``batch`` rule maps to: what
    batch rows split over, and what replicated gradients are summed over."""
    return plan._mesh_axes_for("batch")


@contextmanager
def whole_rows():
    """Within the block the calling thread's batch rows are whole on every
    rank (module doc)."""
    old = getattr(_plan_state, "whole_rows", False)
    _plan_state.whole_rows = True
    try:
        yield
    finally:
        _plan_state.whole_rows = old


def row_axes(plan: ShardingPlan) -> Tuple[str, ...]:
    """The mesh axes the current call's batch rows are split over: the
    batch axes, or none inside :func:`whole_rows`."""
    return () if getattr(_plan_state, "whole_rows", False) else batch_axes(plan)


def _index_along(plan: ShardingPlan, axes: Sequence[str]) -> int:
    """This rank's index along ``axes`` taken together, rank-major
    (outermost first, as :func:`shard_slices` numbers the shards)."""
    index = 0
    for a in axes:
        index = index * plan.mesh.shape[a] + plan.mesh.coords[a]
    return index


def rows_split(plan: ShardingPlan, batch: int) -> bool:
    """Whether a ``batch``-row array's batch dim takes the batch axes (they
    divide it), as :meth:`ShardingPlan.spec_for` decides."""
    axes = batch_axes(plan)
    return bool(axes) and batch % math.prod(plan.mesh.shape[a] for a in axes) == 0


def residual_split(plan: Optional[ShardingPlan], batch: int, seq: int) -> bool:
    """Whether ``plan`` (ranked) splits a ``(batch, seq, D)`` residual
    stream along its sequence over ``model`` (the ``seq`` rule, where the
    axis divides ``seq``): a training step then runs sequence-parallel.
    Only ``model`` may carry ``seq``; any other axis raises."""
    plan = ranked_plan(plan)
    if plan is None:
        return False
    parts = plan.spec_for(ArraySpec((batch, seq, 1), "float32", ("batch", "seq", None)))
    axes = axes_of(parts[1])
    if axes and axes != ("model",):
        raise NotImplementedError(f"the residual stream's sequence splits over {axes}: the "
                                  "explicit layout runs sequence parallelism over 'model' only")
    return bool(axes)


@contextmanager
def seq_sharded(on: bool = True):
    """Within the block the calling thread's residual stream is this rank's
    range of positions along ``model`` (sequence parallelism; module doc)."""
    old = getattr(_plan_state, "seq_sharded", False)
    _plan_state.seq_sharded = bool(on)
    try:
        yield
    finally:
        _plan_state.seq_sharded = old


def seq_split() -> bool:
    """Whether the calling thread runs inside :func:`seq_sharded`."""
    return getattr(_plan_state, "seq_sharded", False)


@dataclass(frozen=True)
class KVSeqSplit:
    """How a decode cache's positions split across ranks: the mesh ``axes``
    (outermost first), their product ``n`` and this rank's ``index`` along
    them; a rank holds positions ``[index * S, (index + 1) * S)`` of a cache
    whose local length is ``S``."""

    axes: Tuple[str, ...]
    n: int
    index: int

    def offset(self, local_len: int) -> int:
        return self.index * local_len


def kv_seq_split(plan: Optional[ShardingPlan], batch: int) -> Optional[KVSeqSplit]:
    """The split of a ``batch``-row decode cache's ``kv_seq`` dim under
    ``plan`` (ranked): the axes the ``kv_seq`` rule names (present, size
    > 1) that the batch dim before it did not take (:func:`rows_split`),
    or None where there are none. :func:`check_kv_seq` holds a cache's
    length to dividing them, so a local cache of length ``S`` stands for
    ``S * n`` positions."""
    plan = ranked_plan(plan)
    if plan is None:
        return None
    used = set(batch_axes(plan)) if rows_split(plan, batch) else set()
    axes = tuple(a for a in plan._mesh_axes_for("kv_seq") if a not in used)
    if not axes:
        return None
    return KVSeqSplit(axes, math.prod(plan.mesh.shape[a] for a in axes), _index_along(plan, axes))


def check_kv_seq(plan: Optional[ShardingPlan], specs) -> None:
    """Raise where a spec of a cache tree puts ``kv_seq`` on axes that do
    not divide its length: the layers read a local cache's positions as
    this rank's range (:func:`kv_seq_split`), which a cache kept whole
    would break."""
    plan = ranked_plan(plan)
    if plan is None:
        return
    for path, spec in spec_items(specs):
        if "kv_seq" not in spec.axes:
            continue
        dim = spec.axes.index("kv_seq")
        parts = plan.spec_for(spec)
        used = {a for p in parts[:dim] for a in axes_of(p)}
        want = tuple(a for a in plan._mesh_axes_for("kv_seq") if a not in used)
        if want and axes_of(parts[dim]) != want:
            raise ValueError(
                f"cache leaf {path} {spec.shape}: {spec.shape[dim]} positions do not split "
                f"over the kv_seq axes {want} of mesh {plan.mesh.shape}")


def rows_of(plan: ShardingPlan, batch: int) -> Optional[slice]:
    """The slice of a ``batch``-row batch that this rank holds when the
    batch axes divide it (rank-major over the axes, outermost first), or
    None when its rows stay whole on every rank (no batch axis, or one that
    does not divide ``batch``)."""
    if not rows_split(plan, batch):
        return None
    axes = batch_axes(plan)
    size = batch // math.prod(plan.mesh.shape[a] for a in axes)
    index = _index_along(plan, axes)
    return slice(index * size, (index + 1) * size)


def _constrain(x: torch.Tensor, axes: Sequence[Optional[str]], uneven: bool) -> torch.Tensor:
    plan = current_plan()
    if plan is None:
        return x
    spec = ArraySpec(tuple(x.shape), "float32", tuple(axes))  # the hint's rank
    if ranked_plan(plan) is None:
        plan.spec_for(spec, uneven=uneven)  # its rules; one rank holds x whole
        return x
    entries = plan.spec_for(spec, uneven=True)
    rows = set(batch_axes(plan))
    full = list(x.shape)
    for i, part in enumerate(entries):
        mesh_axes = axes_of(part)
        if not mesh_axes:
            continue
        if axes[i] not in ("seq", "kv_seq") and not set(mesh_axes) <= rows:
            raise ValueError(
                f"hint {tuple(axes)} shards dim {i} over {mesh_axes}, but the explicit "
                f"layout keeps it whole on every rank (shape {tuple(x.shape)})")
        full[i] *= math.prod(plan.mesh.shape[a] for a in mesh_axes)
    # the shape x implies in full must shard back to x under the hint
    local = plan.local_shape(ArraySpec(tuple(full), "float32", tuple(axes)))
    if local != tuple(x.shape):
        raise ValueError(f"{tuple(x.shape)} is not the local shard {local} that hint "
                         f"{tuple(axes)} implies under mesh {plan.mesh.shape}")
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


# -- local shards --------------------------------------------------------------


def shard_slices(plan: ShardingPlan, spec: ArraySpec, coords: Mapping[str, int]):
    """The slice of each dim of the full array ``spec`` that the rank at
    ``coords`` holds (an entry of several axes indexes outermost first)."""
    out = []
    for dim, part in zip(spec.shape, plan.spec_for(spec)):
        axes = axes_of(part)
        if not axes:
            out.append(slice(None))
            continue
        n = math.prod(plan.mesh.shape[a] for a in axes)
        index = 0
        for a in axes:
            index = index * plan.mesh.shape[a] + coords[a]
        size = dim // n
        out.append(slice(index * size, (index + 1) * size))
    return tuple(out)


def quant_part_specs(spec: ArraySpec, values_k: int) -> Tuple[ArraySpec, ArraySpec]:
    """The specs of a quantized weight's two parts, from the weight's own
    ``spec`` (..., K, N): the values at ``values_k`` rows of K (the packed
    ceil(K/2) for int4) on the same axes, the scales with the K entry
    dropped."""
    values = ArraySpec(spec.shape[:-2] + (values_k, spec.shape[-1]), "int8", spec.axes)
    scales = ArraySpec(spec.shape[:-2] + spec.shape[-1:], "float32",
                       spec.axes[:-2] + spec.axes[-1:])
    return values, scales


def check_quant_layout(plan: ShardingPlan, spec: ArraySpec, values_k: int) -> None:
    """Raise unless the values of a quantized weight split as the weight
    does: an int4 shard of K must hold whole nibble pairs (an even local
    K), or the packed rows would not split with it."""
    values, _ = quant_part_specs(spec, values_k)
    if plan.spec_for(values) != plan.spec_for(spec):
        raise ValueError(
            f"an int4 weight {spec.shape} splits its K={spec.shape[-2]} into local shards of "
            f"odd length under mesh {plan.mesh.shape}: a shard must hold whole nibble pairs")


def shard_leaf(full, plan: ShardingPlan, spec: ArraySpec, coords: Mapping[str, int]):
    """This rank's shard of one full leaf (a contiguous copy); a
    :class:`~repro_torch.core.quant.QuantizedTensor` as its values and
    scales (:func:`quant_part_specs`)."""
    if is_quantized(full):
        if tuple(full.shape) != tuple(spec.shape):
            raise ValueError(f"leaf {tuple(full.shape)} vs its spec {spec.shape}")
        check_quant_layout(plan, spec, full.values.shape[-2])
        values, scales = quant_part_specs(spec, full.values.shape[-2])
        local_k = plan.local_shape(spec)[-2]
        return QuantizedTensor(shard_leaf(full.values, plan, values, coords),
                               shard_leaf(full.scales, plan, scales, coords), bits=full.bits,
                               act_bits=full.act_bits, k=local_k if full.bits == 4 else None)
    if tuple(full.shape) != tuple(spec.shape):
        raise ValueError(f"leaf {tuple(full.shape)} vs its spec {spec.shape}")
    return full[shard_slices(plan, spec, coords)].contiguous()


#: Adafactor's moments of a parameter ``<param>``: ``<param>/vr`` (the
#: mean over its last dim), ``<param>/vc`` (over dim -2), ``<param>/v``
#: (a vector's, unfactored)
MOMENT_KEYS = ("vr", "vc", "v")


def moment_spec(spec: ArraySpec, key: str) -> ArraySpec:
    """The spec of Adafactor's moment ``key`` (:data:`MOMENT_KEYS`) of a
    parameter of spec ``spec``: the parameter's without the dim it reduces."""
    if key == "vr":
        keep = list(range(len(spec.shape) - 1))
    elif key == "vc":
        keep = list(range(len(spec.shape) - 2)) + [len(spec.shape) - 1]
    else:
        keep = list(range(len(spec.shape)))
    return ArraySpec(tuple(spec.shape[i] for i in keep), "float32",
                     tuple(spec.axes[i] for i in keep), "zeros")


def mirror_specs(tree, specs):
    """An ArraySpec tree for ``tree`` (tensors, full or local): a leaf whose
    path ends in a path of ``specs`` (an optimizer moment ``opt/mu/<param>``
    mirrors ``<param>``) takes that spec when the ranks agree, an Adafactor
    moment ``<param>/vr``, ``/vc`` or ``/v`` its :func:`moment_spec`; any
    other leaf (a counter, the step) is replicated at its own shape."""
    flat = dict(spec_items(specs))

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, f"{path}{k}/") for k, v in t.items()}
        if is_quantized(t):
            return flat[path[:-1]]
        parts = path[:-1].split("/")
        for i in range(len(parts)):
            spec = flat.get("/".join(parts[i:]))
            if spec is not None and len(spec.shape) == t.dim():
                return spec
        if parts[-1] in MOMENT_KEYS:
            for i in range(len(parts) - 1):
                spec = flat.get("/".join(parts[i:-1]))
                if spec is not None and len(spec.shape) - (parts[-1] != "v") == t.dim():
                    return moment_spec(spec, parts[-1])
        return ArraySpec(tuple(t.shape), "float32", (None,) * t.dim())

    return walk(tree, "")


def shard_tree(full, plan: ShardingPlan, coords: Mapping[str, int], specs):
    """The full tree ``full`` (nested dicts of tensors) as the rank at
    ``coords`` holds it under ``plan``: each leaf sliced by
    :meth:`ShardingPlan.spec_for` of its spec (``specs``: the tree's
    ArraySpecs, or a parameter spec tree it mirrors, :func:`mirror_specs`)
    down to :meth:`ShardingPlan.local_shape`."""
    spec_tree = mirror_specs(full, specs)

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        if not isinstance(t, (torch.Tensor, QuantizedTensor)):
            raise TypeError(f"shard_tree takes tensors, not {type(t).__name__}")
        return shard_leaf(t, plan, s, coords)

    return walk(full, spec_tree)


def gather_leaf(local, plan: ShardingPlan, spec: ArraySpec):
    """The full leaf from every rank's shard (a collective: every rank of
    the mesh calls it, and every rank gets the whole leaf)."""
    from repro_torch.dist.collectives import mesh_axis, raw_all_gather

    if is_quantized(local):
        full_k = spec.shape[-2] if local.bits == 8 else (spec.shape[-2] + 1) // 2
        values, scales = quant_part_specs(spec, full_k)
        return QuantizedTensor(gather_leaf(local.values, plan, values),
                               gather_leaf(local.scales, plan, scales), bits=local.bits,
                               act_bits=local.act_bits,
                               k=spec.shape[-2] if local.bits == 4 else None)
    out = local
    for dim, part in enumerate(plan.spec_for(spec)):
        for a in reversed(axes_of(part)):  # innermost axis first
            ax = mesh_axis(a, plan.mesh)
            if ax is not None:
                out = raw_all_gather(out, ax, dim)
    return out


def gather_tree(local, plan: ShardingPlan, specs):
    """The inverse of :func:`shard_tree`: every leaf whole (a collective)."""
    spec_tree = mirror_specs(local, specs)

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        return gather_leaf(t, plan, s)

    return walk(local, spec_tree)


def local_specs(specs, plan: Optional[ShardingPlan] = None):
    """``specs`` at the local shapes of a ranked plan (default: the
    installed one); ``specs`` itself without one."""
    plan = ranked_plan(plan)
    if plan is None:
        return specs
    return _map_specs(lambda s: ArraySpec(plan.local_shape(s), s.dtype, s.axes, s.init), specs)


def local_rows(batch: Mapping[str, torch.Tensor], plan: Optional[ShardingPlan] = None):
    """A global batch (a dict of arrays whose axis 0 is the batch) cut to
    this rank's rows under a ranked plan; the batch itself without one."""
    plan = ranked_plan(plan)
    if plan is None:
        return dict(batch)
    out = {}
    for key, v in batch.items():
        spec = ArraySpec(tuple(v.shape), "float32", ("batch",) + (None,) * (v.dim() - 1))
        out[key] = v[shard_slices(plan, spec, plan.mesh.coords)]
    return out
