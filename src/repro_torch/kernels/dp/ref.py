"""Plain oracle for the data-parallel GEMM (counterpart of the JAX package's
``gemm_ref``): an f32-accumulated matmul with the epilogue, cast to the
output dtype."""

from __future__ import annotations

from repro_torch.kernels.common import apply_epilogue, mixed_dot


def dp_gemm_ref(a, b, *, out_dtype=None, epilogue="none", bias=None, operand=None):
    """epilogue(a @ b) with f32 accumulation, cast to ``out_dtype``."""
    acc = apply_epilogue(mixed_dot(a, b), epilogue, bias=bias, operand=operand)
    return acc.to(out_dtype or a.dtype)
