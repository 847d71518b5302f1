"""Mesh descriptions (the counterpart of ``repro.launch.mesh``).

Single pod: 256 chips as (data=16, model=16). Multi-pod: 2 pods = 512 chips
as (pod=2, data=16, model=16); the ``pod`` axis is an outer data-parallel
axis, so the sharding rules place only the gradient all-reduce on it.

A :class:`MeshShape` holds axis names and sizes and no devices: the
sharding solver (``repro_torch.dist.sharding.ShardingPlan``) and the dry
run need nothing more, so a 512-chip plan is solved on one host.

A :class:`HostMesh` is a mesh of real ranks (``make_host_mesh``): the
``torch.distributed`` world as (data, model), with this rank's coordinates
and one process group per axis, which the explicit collectives of
``repro_torch.dist.collectives`` run over. Ranks are laid out data-major:
rank ``r`` sits at (data ``r // model``, model ``r % model``). A *virtual*
host mesh (``virtual_mesh``) has the coordinates and no groups: the dry run
traces one rank's step under it, and every collective is recorded at its
local shapes without communicating.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple


@dataclass(frozen=True)
class MeshShape:
    """A device-free mesh: ``axis_names`` and their sizes, outermost first."""

    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"mesh sizes {self.sizes} vs axes {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (``jax.sharding.Mesh.shape``'s form)."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """The number of devices the mesh spans."""
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False, shape: Optional[Sequence[int]] = None):
    """Default (16, 16) / (2, 16, 16); ``shape`` overrides the (data, model)
    factorisation (e.g. (32, 8)) keeping the chip counts."""
    if shape is None:
        shape = (2, 16, 16) if multi_pod else (16, 16)
    else:
        shape = tuple(shape)
        if multi_pod and len(shape) == 2:
            shape = (2, *shape)
    n = math.prod(shape)
    assert n in (256, 512), f"production pod sizes are 256/512 chips, got {n}"
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return MeshShape(tuple(int(d) for d in shape), axes)


@dataclass(frozen=True)
class HostMesh(MeshShape):
    """A mesh of ranks: :class:`MeshShape` plus this rank's ``coords`` (axis
    -> index) and ``groups`` (axis -> process group, for the axes of size
    > 1). ``virtual``: no groups; the collectives only record."""

    coords: Dict[str, int] = field(default_factory=dict, compare=False)
    groups: Dict[str, Any] = field(default_factory=dict, compare=False, repr=False)
    virtual: bool = False

    @property
    def ranked(self) -> bool:
        """Whether the mesh spans more than one rank (tensors are then
        per-rank shards and the layers run collectives)."""
        return self.size > 1


def make_host_mesh(model: int = 1) -> HostMesh:
    """The ``torch.distributed`` world as (data = W // ``model``, model), W
    the world size (one rank without a process group: (1, 1)). Every rank
    must call it, in the same order as its other group creations: it makes
    one process group per data row and per model column."""
    import torch.distributed as dist

    n = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    assert n % model == 0, f"{n} rank(s) do not split into a model axis of {model}"
    data = n // model
    rank = dist.get_rank() if n > 1 else 0
    coords = {"data": rank // model, "model": rank % model}
    groups = {}
    # new_group is collective over the world: every rank makes every group
    if model > 1:
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if coords["data"] == d:
                groups["model"] = g
    if data > 1:
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if coords["model"] == m:
                groups["data"] = g
    return HostMesh((data, model), ("data", "model"), coords=coords, groups=groups)


def virtual_mesh(sizes: Sequence[int], axis_names: Optional[Sequence[str]] = None,
                 coords: Optional[Dict[str, int]] = None) -> HostMesh:
    """A host mesh without ranks (module doc): ``sizes`` over ``axis_names``
    ((data, model), or (pod, data, model) for three sizes), this rank at
    ``coords`` (all 0 by default)."""
    sizes = tuple(int(d) for d in sizes)
    if axis_names is None:
        axis_names = ("pod", "data", "model") if len(sizes) == 3 else ("data", "model")
    axis_names = tuple(axis_names)
    coords = dict(coords or {a: 0 for a in axis_names})
    return HostMesh(sizes, axis_names, coords=coords, virtual=True)
