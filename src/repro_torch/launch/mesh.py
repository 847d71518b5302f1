"""Mesh descriptions (the counterpart of ``repro.launch.mesh``).

Single pod: 256 chips as (data=16, model=16). Multi-pod: 2 pods = 512 chips
as (pod=2, data=16, model=16); the ``pod`` axis is an outer data-parallel
axis, so the sharding rules place only the gradient all-reduce on it.

A :class:`MeshShape` holds axis names and sizes and no devices: the
sharding solver (``repro_torch.dist.sharding.ShardingPlan``) and the dry
run need nothing more, so a 512-chip plan is solved on one host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple


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


def make_host_mesh(model: int = 1):
    """What this host's process group offers: (data, model) over its ranks
    (one rank without a process group)."""
    import torch.distributed as dist

    n = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    assert n % model == 0, f"{n} rank(s) do not split into a model axis of {model}"
    return MeshShape((n // model, model), ("data", "model"))
