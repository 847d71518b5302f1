"""Parameter specs and their initialisation (the minimal counterpart of
``repro.dist.sharding``): one device, so logical axes are carried for
parity with the JAX package's specs and ``constrain`` is a no-op."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.core.gemm import as_dtype


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


def init_leaf(spec: ArraySpec, generator: torch.Generator, device) -> torch.Tensor:
    """Materialise one spec as ``repro``'s ``_init_leaf`` does: zeros, ones,
    or a fan-in-scaled normal (the second-to-last dim is the fan-in, so a
    leading stacked-layer axis never counts). Stacked leaves are drawn one
    layer at a time, so the f32 draw never holds more than one layer."""
    dtype = as_dtype(spec.dtype)
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


def constrain(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Sharding hint by logical axis names: a no-op on one device."""
    return x
