"""Plain oracle for the split-K baseline (counterpart of
``repro.kernels.splitk.ref``)."""

from __future__ import annotations

from repro_torch.kernels.common import mixed_dot


def gemm_ref(a, b, out_dtype=None):
    """f32-accumulated ``a @ b`` cast to ``out_dtype`` (defaults to a.dtype)."""
    return mixed_dot(a, b).to(out_dtype or a.dtype)
