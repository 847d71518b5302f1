"""Shared helpers for the Hopper GEMM kernels: launch counting, padding, the
plain epilogue and MAC, and the argument checks every CUDA wrapper runs.

Counterpart of ``repro.kernels.common``. The launch counters are plain
integers that a wrapper bumps where it launches its CUDA kernel and nowhere
else, so a run can show that the main path really went through the kernels;
the plain versions a wrapper runs on CPU tensors never count.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.op import Epilogue, as_epilogue
from repro_torch.core.workpart import cdiv

#: CUDA launches of each hand-written kernel since the last reset.
LAUNCHES: Dict[str, int] = {
    "dp_gemm_region": 0,
    "streamk_phase1": 0,
    "streamk_fixup": 0,
    "grouped_streamk_sk": 0,
    "grouped_streamk_dp": 0,
}

#: active launch log (None when no count_launches scope is open)
_launch_log: Optional[List[str]] = None


def record_launch(name: str) -> None:
    """Count one CUDA launch of kernel ``name`` (called by the wrappers right
    where they launch, never on the plain path)."""
    LAUNCHES[name] += 1
    if _launch_log is not None:
        _launch_log.append(name)


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextmanager
def count_launches() -> Iterator[List[str]]:
    """Collect the names of the kernels launched within the scope."""
    global _launch_log
    prev = _launch_log
    _launch_log = log = []
    try:
        yield log
    finally:
        _launch_log = prev


def pad_to(x: torch.Tensor, mults) -> torch.Tensor:
    """Zero-pad each dim of ``x`` up to a multiple of ``mults`` (a copy; only
    the plain versions use it — the kernels mask ragged edges instead)."""
    pads = []
    for dim, mult in reversed(list(zip(x.shape, mults))):
        pads.extend((0, cdiv(dim, mult) * mult - dim))
    return F.pad(x, pads) if any(pads) else x


def unpad(x: torch.Tensor, shape) -> torch.Tensor:
    """Slice back to an original (unpadded) shape."""
    if tuple(x.shape) == tuple(shape):
        return x
    return x[tuple(slice(0, d) for d in shape)]


def prep_scale(scale, n: int, bn: int):
    """Per-output-channel dequant vector -> the padded (1, Np) f32 row the
    quantized rung's flush/fix-up reads (the layout of
    ``repro.kernels.common.prep_scale``)."""
    if scale is None:
        return None
    return pad_to(scale.reshape(1, n).to(torch.float32), (1, bn))


def apply_epilogue(acc, epilogue, bias=None, operand=None):
    """Plain epilogue on the f32 accumulator (bias -> activation -> binary).
    The dequant ``scale``/``scale_a`` stages of the quantized rung are not
    ported yet; the wrappers refuse them before getting here."""
    spec: Epilogue = as_epilogue(epilogue)
    return spec.apply(acc, bias=bias, operand=operand)


def mixed_dot(a_blk: torch.Tensor, b_blk: torch.Tensor) -> torch.Tensor:
    """Plain f32-accumulated MAC for the dense dtypes (f32 x f32, bf16 x
    bf16): both operands widen to f32, so products are exact and the sum is
    f32 — the semantics of ``jnp.dot(preferred_element_type=f32)``."""
    if not (a_blk.is_floating_point() and b_blk.is_floating_point()):
        raise NotImplementedError("integer MACs belong to the quantized rung")
    return torch.matmul(a_blk.to(torch.float32), b_blk.to(torch.float32))


#: dtype codes of the C entry points
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

ACT_CODES = {"none": 0, "relu": 1, "gelu": 2, "silu": 3, "square": 4}
BINARY_CODES = {"none": 0, "mul_silu": 1, "add": 2}


def refuse_quantized(scale, scale_a, b_bits: int) -> None:
    """The quantized rung (int8/int4 weights, dequant scales) is not ported:
    raise instead of quietly dropping a dequant stage."""
    if scale is not None or scale_a is not None or b_bits != 8:
        raise NotImplementedError(
            "quantized GEMM arguments (scale, scale_a, b_bits=4) are not "
            "ported to the Hopper kernels yet"
        )


def check_cuda_operands(a, b, out_dtype, bias, operand) -> None:
    """Validate what the CUDA kernels take: CUDA tensors on one device,
    contiguous row-major (M, K) @ (K, N) — or (G, M, K) @ (G, K, N) for the
    grouped kernel, with bias (G, N) and operand (G, M, N) — f32 or bf16
    inputs of one dtype, an f32 or bf16 output, and epilogue operands in the
    output dtype."""
    lead = tuple(a.shape[:-2])
    if (
        a.dim() not in (2, 3) or b.dim() != a.dim() or tuple(b.shape[:-2]) != lead
        or a.shape[-1] != b.shape[-2]
    ):
        raise ValueError(f"bad gemm operands {tuple(a.shape)} @ {tuple(b.shape)}")
    if not (a.is_cuda and b.device == a.device):
        raise ValueError("the CUDA kernels need both operands on one CUDA device")
    if a.dtype != b.dtype or a.dtype not in DTYPE_CODES:
        raise NotImplementedError(
            f"the CUDA kernels take f32 or bf16 operands of one dtype, got "
            f"{a.dtype} @ {b.dtype}"
        )
    if out_dtype not in DTYPE_CODES:
        raise NotImplementedError(f"unsupported output dtype {out_dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("the CUDA kernels need contiguous row-major operands")
    m, n = a.shape[-2], b.shape[-1]
    for name, t, shape in (("bias", bias, (*lead, n)), ("operand", operand, (*lead, m, n))):
        if t is None:
            continue
        if tuple(t.shape) != shape or t.dtype != out_dtype or t.device != a.device:
            raise ValueError(
                f"{name} must be a {shape} {out_dtype} tensor on {a.device}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def sub_block_rows(bm: int, m: int) -> int:
    """Rows of the sub-block a CUDA block walks a bm-row tile in: the largest
    of 64/32/16/8 that divides bm and does not exceed M rounded up to 8, so
    a 4-row decode GEMM never computes 60 padded rows."""
    cap = max(8, cdiv(m, 8) * 8)
    for rows in (64, 32, 16, 8):
        if bm % rows == 0 and rows <= cap:
            return rows
    return 8


def rows_aligned(a: torch.Tensor, b: torch.Tensor) -> int:
    """1 when every row of A and B starts on a 16-byte boundary (base
    addresses and row pitches — for stacked (G, ., .) operands the group
    pitches follow), so the kernels may stage them with 16-byte ``cp.async``
    copies; 0 sends them down the element-wise path."""
    e = a.element_size()
    return int(
        a.data_ptr() % 16 == 0
        and b.data_ptr() % 16 == 0
        and (a.shape[-1] * e) % 16 == 0
        and (b.shape[-1] * e) % 16 == 0
    )


def stream_ptr(device) -> int:
    """Handle of PyTorch's current stream on ``device`` (kernels launch there
    and do not synchronise)."""
    return torch.cuda.current_stream(device).cuda_stream


def epilogue_args(epilogue, bias, operand):
    """(bias_ptr, operand_ptr, act, binary) for a C entry point."""
    spec = as_epilogue(epilogue)
    if spec.bias != (bias is not None):
        raise ValueError(f"epilogue {spec.name!r} and bias presence disagree")
    if (spec.binary != "none") != (operand is not None):
        raise ValueError(f"epilogue {spec.name!r} and operand presence disagree")
    return (
        None if bias is None else bias.data_ptr(),
        None if operand is None else operand.data_ptr(),
        ACT_CODES[spec.activation],
        BINARY_CODES[spec.binary],
    )
