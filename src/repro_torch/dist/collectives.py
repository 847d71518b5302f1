"""Explicit collectives over a named mesh axis, with their accounting (the
port's counterpart of the collectives ``repro`` leaves to XLA, and of
``repro.dist.hlo``'s ``CollectiveStats``).

Under a ranked plan (:func:`~repro_torch.dist.sharding.current_plan` over a
:class:`~repro_torch.launch.mesh.HostMesh` of more than one rank) every
tensor is this rank's shard, and the model code exchanges what its layout
needs through the functions here:

* :func:`all_reduce` — the sum of a partial result over an axis; its
  backward is the identity (the gradient of a replicated output is already
  whole on every rank, so it is not counted W times).
* :func:`sum_grad` — its dual: the identity forward, an all-reduce of the
  gradient backward (a replicated input that feeds rank-partial work).
* :func:`all_gather` — the shards of an axis concatenated along ``dim``;
  backward a reduce-scatter (each rank's consumer differs, as an FSDP
  weight's batch rows do) or, with ``grad="slice"``, this rank's slice
  (the consumer is replicated, as the loss over gathered logits is).
* :func:`reduce_scatter` — the sum, of which each rank keeps its slice;
  backward an all-gather.
* :func:`split` — this rank's slice of a replicated tensor (no
  exchange); backward an all-gather of the slices' gradients, so the
  replicated producer sees the whole gradient.
* :func:`all_to_all` — chunk ``split_dim`` over the axis and concatenate
  what arrives along ``concat_dim``; backward the reverse exchange.
* :func:`all_reduce_max` — the elementwise maximum over axes (no
  gradient): a quantization scale's amax over a contraction axis that the
  ranks split, so every rank's scale is the whole axis's.
* :func:`all_gather_rows` — the batch rows of every data rank, in rank
  order (the decode logits, so every rank samples the same tokens).

On an axis of size 1, or without a ranked plan, each is the identity and
records nothing (XLA emits no collective there either).

**Accounting.** Every collective a rank runs, forward or backward, is
added to each open :func:`record` as ``repro``'s HLO parse would count it:
the op's HLO name and the payload bytes of its *result* (its local shape
and dtype; a maximum counts as an ``all-reduce``, as a sum does), with
:attr:`CollectiveStats.coll_bytes` applying ``repro.dist.hlo_cost``'s x2 for an all-reduce (a ring moves about twice
its buffer). ``seconds`` adds the host wall time spent inside the calls,
each timed from a synchronised device: the exchange itself (over ``gloo``
its copies through host memory included), not the queued work before it.

**Virtual mode.** On a virtual host mesh (the dry run) nothing is
communicated: each call records itself and returns a meta tensor of the
result's local shape.

**gloo.** Ranks that share one card cannot use NCCL (it refuses two ranks
on one device), so they run over ``gloo``, which stages CUDA tensors
through host memory. ``gloo`` has ``all_reduce`` and ``all_gather`` on
CUDA tensors; this module composes the others from them: a
**reduce-scatter** is an all-reduce followed by this rank's slice, and an
**all-to-all** is an all-gather from which each rank keeps the chunks
addressed to it. The record keeps the op they stand for. A collective that
fails raises; nothing is retried.
"""

from __future__ import annotations

import math
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from repro_torch.dist.sharding import current_plan

#: the collective op names of ``repro.dist.hlo`` (HLO's spelling)
COLLECTIVE_OPS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

#: ``repro.dist.hlo_cost``'s traffic multiplier per op (a ring all-reduce
#: moves about twice its buffer; the others about once)
BYTES_MULT = {"all-reduce": 2}


@dataclass
class CollectiveStats:
    """Collectives counted by op (``repro.dist.hlo.CollectiveStats``'s
    fields): ``per_op`` maps an op name to (count, payload bytes)."""

    per_op: Dict[str, Tuple[int, int]] = field(default_factory=dict)
    #: host wall seconds spent inside the recorded calls, each from a
    #: synchronised device (the exchanges alone)
    seconds: float = 0.0

    @property
    def total_bytes(self) -> int:
        return sum(b for _, b in self.per_op.values())

    @property
    def total_count(self) -> int:
        return sum(c for c, _ in self.per_op.values())

    @property
    def coll_bytes(self) -> int:
        """Payload bytes with ``repro.dist.hlo_cost``'s multiplier (x2 for an
        all-reduce): ``repro``'s ``cost.collective_bytes``."""
        return sum(b * BYTES_MULT.get(op, 1) for op, (_, b) in self.per_op.items())

    def counts(self) -> Dict[str, int]:
        """Op -> count (``repro``'s ``cost.collective_counts``)."""
        return {op: c for op, (c, _) in sorted(self.per_op.items())}

    def summary(self) -> Dict[str, Dict[str, int]]:
        return {op: {"count": c, "bytes": b} for op, (c, b) in sorted(self.per_op.items())}

    def add(self, op: str, nbytes: int, count: int = 1) -> None:
        c, b = self.per_op.get(op, (0, 0))
        self.per_op[op] = (c + count, b + nbytes)

    def merge(self, other: "CollectiveStats") -> None:
        """Add ``other``'s counts, bytes and seconds to these."""
        for op, (c, b) in other.per_op.items():
            self.add(op, b, c)
        self.seconds += other.seconds


_recorders: List[CollectiveStats] = []
_lock = threading.Lock()


@contextmanager
def record() -> Iterator[CollectiveStats]:
    """Count every collective run in this process while the block runs
    (on any thread: a backward runs on autograd's)."""
    stats = CollectiveStats()
    with _lock:
        _recorders.append(stats)
    try:
        yield stats
    finally:
        with _lock:
            _recorders.remove(stats)


def _note(op: str, shape, dtype: torch.dtype, seconds: float = 0.0) -> None:
    nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    with _lock:
        for stats in _recorders:
            stats.add(op, nbytes)
            stats.seconds += seconds


@dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its size, this rank's index on
    it, its process group (None on a virtual mesh)."""

    name: str
    size: int
    index: int
    group: object
    virtual: bool


def mesh_axis(name: str, mesh=None) -> Optional[Axis]:
    """``name`` on ``mesh`` (default: the installed plan's), or None where
    there is nothing to exchange: no ranked plan, or an axis of size 1."""
    if mesh is None:
        plan = current_plan()
        mesh = None if plan is None else plan.mesh
    if mesh is None or not getattr(mesh, "ranked", False):
        return None
    size = int(mesh.shape.get(name, 1))
    if size == 1:
        return None
    virtual = bool(mesh.virtual)
    group = None if virtual else mesh.groups[name]
    return Axis(name, size, int(mesh.coords[name]), group, virtual)


class _Timed:
    """Times one exchange on the host clock. A CUDA tensor's device is
    synchronised first, so the time holds the exchange alone and not the
    device work still queued before it (``gloo`` would wait for that)."""

    def __init__(self, op, shape, dtype, device):
        self.op, self.shape, self.dtype, self.device = op, tuple(shape), dtype, device

    def __enter__(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if exc[0] is None:
            _note(self.op, self.shape, self.dtype, time.perf_counter() - self.t0)


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def raw_all_reduce(x: torch.Tensor, ax: Axis, op: str = "sum") -> torch.Tensor:
    """The sum (or, ``op="max"``, the elementwise maximum) of ``x`` over the
    axis (a new tensor; no autograd)."""
    import torch.distributed as dist

    if ax.virtual:
        _note("all-reduce", x.shape, x.dtype)
        return _meta(x.shape, x.dtype)
    out = x.detach().contiguous().clone()
    with _Timed("all-reduce", out.shape, out.dtype, out.device):
        dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                        group=ax.group)
    return out


def raw_all_gather(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    """The axis's shards of ``x`` concatenated along ``dim`` in rank order."""
    import torch.distributed as dist

    dim = dim % x.dim()
    shape = list(x.shape)
    shape[dim] *= ax.size
    if ax.virtual:
        _note("all-gather", shape, x.dtype)
        return _meta(shape, x.dtype)
    src = x.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(ax.size)]
    with _Timed("all-gather", shape, x.dtype, x.device):
        dist.all_gather(parts, src, group=ax.group)
    return torch.cat(parts, dim=dim)


def raw_reduce_scatter(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    """This rank's slice along ``dim`` of the sum of ``x`` over the axis (an
    all-reduce, then the slice)."""
    import torch.distributed as dist

    dim = dim % x.dim()
    if x.shape[dim] % ax.size:
        raise ValueError(f"reduce-scatter of dim {dim} ({x.shape[dim]}) over {ax.size} ranks")
    chunk = x.shape[dim] // ax.size
    shape = list(x.shape)
    shape[dim] = chunk
    if ax.virtual:
        _note("reduce-scatter", shape, x.dtype)
        return _meta(shape, x.dtype)
    total = x.detach().contiguous().clone()
    with _Timed("reduce-scatter", shape, x.dtype, x.device):
        dist.all_reduce(total, group=ax.group)
    return total.narrow(dim, ax.index * chunk, chunk).contiguous()


def raw_all_to_all(x: torch.Tensor, ax: Axis, split_dim: int, concat_dim: int) -> torch.Tensor:
    """Chunk ``split_dim`` into one piece per rank, send piece ``r`` to rank
    ``r``, and concatenate the pieces received along ``concat_dim`` in rank
    order (an all-gather, of which each rank keeps its pieces)."""
    import torch.distributed as dist

    split_dim, concat_dim = split_dim % x.dim(), concat_dim % x.dim()
    if x.shape[split_dim] % ax.size:
        raise ValueError(f"all-to-all of dim {split_dim} ({x.shape[split_dim]}) over "
                         f"{ax.size} ranks")
    shape = list(x.shape)
    shape[split_dim] //= ax.size
    shape[concat_dim] *= ax.size
    if ax.virtual:
        _note("all-to-all", shape, x.dtype)
        return _meta(shape, x.dtype)
    src = x.detach().contiguous()
    with _Timed("all-to-all", shape, x.dtype, x.device):
        parts = [torch.empty_like(src) for _ in range(ax.size)]
        dist.all_gather(parts, src, group=ax.group)
    return torch.cat([p.chunk(ax.size, dim=split_dim)[ax.index] for p in parts], dim=concat_dim)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return raw_all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return raw_all_reduce(g, ctx.ax), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim, grad):
        ctx.ax, ctx.dim, ctx.grad = ax, dim % x.dim(), grad
        return raw_all_gather(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        ax, dim = ctx.ax, ctx.dim
        if ctx.grad == "slice":
            chunk = g.shape[dim] // ax.size
            return g.narrow(dim, ax.index * chunk, chunk).contiguous(), None, None, None
        return raw_reduce_scatter(g, ax, dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim % x.dim()
        return raw_reduce_scatter(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return raw_all_gather(g, ctx.ax, ctx.dim), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim % x.dim()
        chunk = x.shape[ctx.dim] // ax.size
        return x.narrow(ctx.dim, ax.index * chunk, chunk).contiguous()

    @staticmethod
    def backward(ctx, g):
        return raw_all_gather(g, ctx.ax, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, split_dim, concat_dim):
        ctx.ax, ctx.dims = ax, (split_dim % x.dim(), concat_dim % x.dim())
        return raw_all_to_all(x, ax, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return raw_all_to_all(g, ctx.ax, concat_dim, split_dim), None, None, None


def all_reduce(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Sum of the rank-partial ``x`` over ``axis``; backward the identity."""
    ax = mesh_axis(axis)
    return x if ax is None else _AllReduce.apply(x, ax)


def sum_grad(x: torch.Tensor, axis: str) -> torch.Tensor:
    """``x`` itself; the backward sums the gradient over ``axis`` (a
    replicated input whose consumers on the axis's ranks are partial)."""
    ax = mesh_axis(axis)
    return x if ax is None else _SumGrad.apply(x, ax)


def all_gather(x: torch.Tensor, axis: str, dim: int, *, grad: str = "reduce_scatter"
               ) -> torch.Tensor:
    """The shards of ``axis`` concatenated along ``dim`` (module doc for
    ``grad``)."""
    if grad not in ("reduce_scatter", "slice"):
        raise ValueError(f"grad must be 'reduce_scatter' or 'slice', not {grad!r}")
    ax = mesh_axis(axis)
    return x if ax is None else _AllGather.apply(x, ax, dim, grad)


def reduce_scatter(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """This rank's slice along ``dim`` of the sum over ``axis``."""
    ax = mesh_axis(axis)
    return x if ax is None else _ReduceScatter.apply(x, ax, dim)


def split(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """This rank's slice along ``dim`` of ``x``, replicated over ``axis``
    (module doc)."""
    ax = mesh_axis(axis)
    if ax is None:
        return x
    if x.shape[dim] % ax.size:
        raise ValueError(f"split of dim {dim} ({x.shape[dim]}) over {ax.size} ranks")
    return _Split.apply(x, ax, dim)


def all_to_all(x: torch.Tensor, axis: str, split_dim: int, concat_dim: int) -> torch.Tensor:
    """The all-to-all exchange over ``axis`` (module doc)."""
    ax = mesh_axis(axis)
    return x if ax is None else _AllToAll.apply(x, ax, split_dim, concat_dim)


def all_reduce_max(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """The elementwise maximum of ``x`` over each of ``axes`` (no gradient):
    ``x`` itself where none has ranks."""
    for axis in axes:
        ax = mesh_axis(axis)
        if ax is not None:
            x = raw_all_reduce(x, ax, op="max")
    return x


def all_gather_rows(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """Dim 0 of ``x``, this rank's batch rows, gathered over the batch axes
    ``axes`` (outermost first) in rank order: the innermost axis first, as
    :func:`~repro_torch.dist.sharding.rows_of` numbers the rows. The
    backward keeps this rank's rows."""
    for axis in reversed(tuple(axes)):
        x = all_gather(x, axis, 0, grad="slice")
    return x


def all_reduce_axes(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """:func:`all_reduce` over each of ``axes`` in turn."""
    for axis in axes:
        x = all_reduce(x, axis)
    return x


def _flat_specs(specs) -> Dict[str, object]:
    from repro_torch.dist.sharding import spec_items

    return dict(spec_items(specs))


def sync_grads(grads, specs, plan, seq_leaves=()):
    """Sum each gradient leaf over the batch axes it is not sharded on:
    every data row's rank computed it from its own rows. A leaf sharded
    over a batch axis (FSDP over ``data``) was already summed there by the
    reduce-scatter of its all-gather's backward. ``seq_leaves``: the
    leaves a sequence-parallel step applied to each rank's range of
    positions (the norms), whose gradients cover only those positions and
    are summed over ``model`` too. ``specs``: the parameters' ArraySpec
    tree. Returns ``grads`` with its leaves replaced."""
    from repro_torch.dist.sharding import axes_of, batch_axes
    from repro_torch.utils.trees import tree_items

    flat = _flat_specs(specs)
    rows = batch_axes(plan)
    seq_leaves = set(seq_leaves)
    out = {}
    for name, g in tree_items(grads):
        held = {a for part in plan.spec_for(flat[name]) for a in axes_of(part)}
        over = rows + ("model",) if name in seq_leaves else rows
        for axis in over:
            ax = mesh_axis(axis, plan.mesh)
            if axis not in held and ax is not None:
                g = raw_all_reduce(g, ax)
        out[name] = g
    return _unflatten(grads, out)


def _unflatten(like, flat: Dict[str, torch.Tensor], prefix: str = ""):
    if isinstance(like, dict):
        return {k: _unflatten(v, flat, f"{prefix}{k}/") for k, v in like.items()}
    return flat[prefix[:-1]]


def global_norm(grads, specs, plan) -> torch.Tensor:
    """The L2 norm of the whole gradient across ranks, in f32: each leaf's
    local sum of squares divided by the number of ranks that hold the same
    shard (so a replicated leaf counts once), summed over every mesh axis."""
    from repro_torch.dist.sharding import axes_of
    from repro_torch.utils.trees import tree_items

    flat = _flat_specs(specs)
    sizes = {a: int(n) for a, n in plan.mesh.shape.items() if int(n) > 1}
    sq = None
    for name, g in tree_items(grads):
        held = {a for part in plan.spec_for(flat[name]) for a in axes_of(part)}
        copies = math.prod(n for a, n in sizes.items() if a not in held)
        term = torch.sum(torch.square(g.to(torch.float32))) / copies
        sq = term if sq is None else sq + term
    for axis in sizes:
        sq = raw_all_reduce(sq, mesh_axis(axis, plan.mesh))
    return torch.sqrt(sq)
