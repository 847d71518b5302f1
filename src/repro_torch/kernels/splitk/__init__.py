"""Kernel B6: the split-K GEMM family (K-sliced partials + reduction)."""

from repro_torch.kernels.splitk import ops, ref
from repro_torch.kernels.splitk.splitk_gemm import splitk_partials

__all__ = ["ops", "ref", "splitk_partials"]
