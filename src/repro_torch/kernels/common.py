"""Shared helpers for the Hopper GEMM kernels: launch counting, padding, the
plain epilogue and MAC, and the argument checks every CUDA wrapper runs.

Counterpart of ``repro.kernels.common``. The launch counters are plain
integers that a wrapper bumps where it launches its CUDA kernel and nowhere
else, so a run can show that the main path really went through the kernels;
the plain versions a wrapper runs on CPU tensors never count. A launch of a
quantized instantiation counts under ``"<kernel>[<rung>]"``, the rung named
as the serve CLI names it (:data:`RUNGS`).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.op import Epilogue, as_epilogue
from repro_torch.core.quant import unpack_int4
from repro_torch.core.workpart import cdiv

#: the hand-written kernels, as their launches are counted
KERNELS = (
    "dp_gemm_region",
    "streamk_phase1",
    "grouped_streamk_sk",
    "grouped_streamk_dp",
    "splitk_partials",
)

#: the quantization ladder's rungs: the three of ``serve --quantize``, and
#: ``int4-dynamic``, int4 weights against int8 activations quantized per row
#: at dispatch (``quantize_weight(bits=4, act_bits=8)``), which no serve rung
#: reaches but the kernels take
RUNGS = ("int8", "int8-dynamic", "int4", "int4-dynamic")


#: the activation dtypes on which every kernel runs a tensor-core mainloop:
#: ``csrc/mma_bf16.cuh`` serves bf16 activations (``uses_mma``),
#: ``csrc/mma_s8.cuh`` int8 ones
MMA_ACTIVATIONS = (torch.bfloat16, torch.int8)


def mainloop(kernel: str, a_dtype: torch.dtype) -> str:
    """The MAC ``kernel`` runs for activations of ``a_dtype``: ``"mma"``, a
    tensor-core mainloop, for bf16 activations (``csrc/mma_bf16.cuh``) or
    int8 ones (``csrc/mma_s8.cuh``), whatever the weights; ``"fma"``,
    ``fma_subblock`` of ``csrc/fma_f32.cuh``, for f32 activations (dense f32
    B2 in its k-ordered map). The same for B1, B2 (which runs B3's fix-up
    in its tail and multiplies nothing more there), both B5 forms and B6."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; expected one of {KERNELS}")
    return "mma" if a_dtype in MMA_ACTIVATIONS else "fma"


#: per-device arrival counters of the split tiles of B2 (indexed by tile)
#: and of B5's Stream-K form (indexed by first workgroup): zeroed once, and
#: every launch leaves them at 0 (the last contributor to a tile resets its
#: counter). Launches in turn on one stream may share them; two streams
#: must not, or one launch's arrivals would count toward the other's tiles.
ARRIVAL_COUNTERS: Dict[torch.device, torch.Tensor] = {}


def arrival_counters(n: int, device) -> torch.Tensor:
    """At least ``n`` int32 arrival counters on ``device``, all 0 between
    launches; grown (a new zeroed tensor) when ``n`` passes what it holds,
    so a call costs no memset launch."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:  # one key per card
        device = torch.device("cuda", torch.cuda.current_device())
    cnt = ARRIVAL_COUNTERS.get(device)
    if cnt is None or cnt.numel() < n:
        cnt = torch.zeros(max(n, 264), dtype=torch.int32, device=device)
        ARRIVAL_COUNTERS[device] = cnt
    return cnt


def launch_name(kernel: str, rung: Optional[str] = None) -> str:
    """The launch counter of ``kernel`` on ``rung`` (None: the dense one)."""
    return kernel if rung is None else f"{kernel}[{rung}]"


def rung_of(a_dtype: torch.dtype, b_dtype: torch.dtype, b_bits: int = 8) -> Optional[str]:
    """The rung an (activation, weight) operand pair belongs to, None for
    the dense pairs."""
    if b_bits == 4:
        return "int4" if a_dtype.is_floating_point else "int4-dynamic"
    if b_dtype == torch.int8:
        return "int8" if a_dtype.is_floating_point else "int8-dynamic"
    return None


#: CUDA launches of each hand-written kernel since the last reset
LAUNCHES: Dict[str, int] = {
    launch_name(k, r): 0 for k in KERNELS for r in (None, *RUNGS)
}

#: active launch log (None when no count_launches scope is open)
_launch_log: Optional[List[str]] = None


def record_launch(name: str, rung: Optional[str] = None) -> None:
    """Count one CUDA launch of kernel ``name`` on ``rung`` (called by the
    wrappers right where they launch, never on the plain path)."""
    key = launch_name(name, rung)
    LAUNCHES[key] += 1
    if _launch_log is not None:
        _launch_log.append(key)


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
    """Per-output-channel dequant vector -> the padded (1, Np) f32 row (the
    layout of ``repro.kernels.common.prep_scale``; ``bn=1`` gives the
    unpadded row the plain versions broadcast)."""
    if scale is None:
        return None
    return pad_to(scale.reshape(1, n).to(torch.float32), (1, bn))


def prep_scale_a(scale_a, m: int, bm: int):
    """Per-row activation dequant vector -> the padded (Mp, 1) f32 column,
    the rank-1 partner of :func:`prep_scale`'s row (``bm=1``: unpadded)."""
    if scale_a is None:
        return None
    return pad_to(scale_a.reshape(m, 1).to(torch.float32), (bm, 1))


def apply_epilogue(acc, epilogue, bias=None, operand=None, scale=None, scale_a=None):
    """Plain epilogue on the f32 accumulator, in the kernels' order:
    ``scale_a`` (rows) -> ``scale`` (columns) -> bias -> activation ->
    binary. ``scale``/``scale_a`` broadcast against ``acc`` (a (1, N) row
    and an (M, 1) column, see :func:`prep_scale`)."""
    spec: Epilogue = as_epilogue(epilogue)
    if scale_a is not None:
        acc = acc * scale_a.to(torch.float32)
    if scale is not None:
        acc = acc * scale.to(torch.float32)
    return spec.apply(acc, bias=bias, operand=operand)


def mixed_dot(a_blk: torch.Tensor, b_blk: torch.Tensor) -> torch.Tensor:
    """Plain MAC with ``repro``'s three cases: int8 x int8 accumulates
    exactly in integers and converts to f32; any other pair (f32 x f32,
    bf16 x bf16, float x int8) widens both operands to f32 and sums in f32.
    CUDA has no integer matmul, so there the integer case multiplies in
    float64, which is exact for any sum below 2**53."""
    if a_blk.is_floating_point() or b_blk.is_floating_point():
        return torch.matmul(a_blk.to(torch.float32), b_blk.to(torch.float32))
    wide = torch.float64 if a_blk.is_cuda else torch.int32
    return torch.matmul(a_blk.to(wide), b_blk.to(wide)).to(torch.float32)


def kstep_dot(a: torch.Tensor, b: torch.Tensor, bk: int) -> torch.Tensor:
    """The kernels' MAC over a K range that starts on a ``bk`` boundary:
    int8 x int8 adds each bk step's exact integer product into the f32 sum
    in order (as B1-B3 and B5 do, so the plain versions give the kernels'
    bits); float pairs take one f32 product."""
    if a.is_floating_point() or b.is_floating_point():
        return mixed_dot(a, b)
    acc = mixed_dot(a[..., :bk], b[..., :bk, :])
    for k0 in range(bk, a.shape[-1], bk):
        acc = acc + mixed_dot(a[..., k0 : k0 + bk], b[..., k0 : k0 + bk, :])
    return acc


def unpack_b(b: torch.Tensor, b_bits: int, k: int) -> torch.Tensor:
    """B as the MAC reads it: packed int4 rows unpacked to int8 and cut to
    the logical K (an odd K drops the zero pad row); other B as it is."""
    return unpack_int4(b)[..., :k, :] if b_bits == 4 else b


#: dtype codes of the C entry points (B's packed int4 is code 3)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
INT4_CODE = 3

ACT_CODES = {"none": 0, "relu": 1, "gelu": 2, "silu": 3, "square": 4}
BINARY_CODES = {"none": 0, "mul_silu": 1, "add": 2}

#: the (A, B) operand pairs the kernels are instantiated for: the dense
#: pairs and the quantization ladder's (float x int8, int8 x int8, float x
#: int4 and int8 x int4), as (A dtype, B dtype, b_bits)
CUDA_PAIRS = frozenset({
    (torch.float32, torch.float32, 8),
    (torch.bfloat16, torch.bfloat16, 8),
    (torch.float32, torch.int8, 8),
    (torch.bfloat16, torch.int8, 8),
    (torch.int8, torch.int8, 8),
    (torch.float32, torch.int8, 4),
    (torch.bfloat16, torch.int8, 4),
    (torch.int8, torch.int8, 4),
})


def check_b_bits(b_bits: int) -> None:
    """B is int8 (or a float type) at 8 bits, or packed int4 at 4: raise on
    anything else, before anything runs, on every device."""
    if b_bits not in (8, 4):
        raise ValueError(f"b_bits must be 8 or 4, got {b_bits}")


def b_code(b: torch.Tensor, b_bits: int) -> int:
    """B's dtype code for the C entries."""
    return INT4_CODE if b_bits == 4 else DTYPE_CODES[b.dtype]


def check_cuda_operands(a, b, out_dtype, bias, operand, *, b_bits: int = 8, scale=None,
                        scale_a=None) -> None:
    """Validate what the CUDA kernels take: CUDA tensors on one device,
    contiguous row-major (M, K) @ (K, N) — or (G, M, K) @ (G, K, N) for the
    grouped kernel, with bias (G, N), operand (G, M, N), scale (G, N) and
    scale_a (G, M) — for B packed int4, ``ceil(K/2)`` rows; an operand pair
    of :data:`CUDA_PAIRS`; an f32 or bf16 output; epilogue operands in the
    output dtype and f32 dequant scales."""
    lead = tuple(a.shape[:-2])
    k = a.shape[-1]
    k_rows = (k + 1) // 2 if b_bits == 4 else k
    if (
        a.dim() not in (2, 3) or b.dim() != a.dim() or tuple(b.shape[:-2]) != lead
        or b.shape[-2] != k_rows
    ):
        raise ValueError(f"bad gemm operands {tuple(a.shape)} @ {tuple(b.shape)} "
                         f"(b_bits={b_bits})")
    if not (a.is_cuda and b.device == a.device):
        raise ValueError("the CUDA kernels need both operands on one CUDA device")
    if (a.dtype, b.dtype, b_bits) not in CUDA_PAIRS:
        raise NotImplementedError(
            f"the CUDA kernels take f32 or bf16 operands of one dtype, or a pair of the "
            f"quantization ladder (float or int8 x int8 or packed int4); got "
            f"{a.dtype} @ {b.dtype} (b_bits={b_bits})"
        )
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"unsupported output dtype {out_dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("the CUDA kernels need contiguous row-major operands")
    m, n = a.shape[-2], b.shape[-1]
    for name, t, shape, dtype in (
        ("bias", bias, (*lead, n), out_dtype),
        ("operand", operand, (*lead, m, n), out_dtype),
        ("scale", scale, (*lead, n), torch.float32),
        ("scale_a", scale_a, (*lead, m), torch.float32),
    ):
        if t is None:
            continue
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != a.device:
            raise ValueError(
                f"{name} must be a {shape} {dtype} tensor on {a.device}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def f32_vector(v, shape):
    """A dequant scale as the kernels read it: contiguous f32 of ``shape``
    (None stays None)."""
    return None if v is None else v.reshape(shape).to(torch.float32).contiguous()


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
    addresses and row pitches, each in its own element size — for stacked
    (G, ., .) operands the group pitches follow), so the kernels may stage
    them with 16-byte ``cp.async`` copies; 0 sends them down the
    element-wise path. With int8 or packed int4 B, N must be a multiple of
    16."""
    return int(
        a.data_ptr() % 16 == 0
        and b.data_ptr() % 16 == 0
        and (a.shape[-1] * a.element_size()) % 16 == 0
        and (b.shape[-1] * b.element_size()) % 16 == 0
    )


def stream_ptr(device) -> int:
    """Handle of PyTorch's current stream on ``device`` (kernels launch there
    and do not synchronise)."""
    return torch.cuda.current_stream(device).cuda_stream


def epilogue_args(epilogue, bias, operand, scale=None, scale_a=None):
    """(bias_ptr, operand_ptr, scale_ptr, scale_a_ptr, act, binary) for a C
    entry point."""
    spec = as_epilogue(epilogue)
    if spec.bias != (bias is not None):
        raise ValueError(f"epilogue {spec.name!r} and bias presence disagree")
    if (spec.binary != "none") != (operand is not None):
        raise ValueError(f"epilogue {spec.name!r} and operand presence disagree")
    return (
        None if bias is None else bias.data_ptr(),
        None if operand is None else operand.data_ptr(),
        None if scale is None else scale.data_ptr(),
        None if scale_a is None else scale_a.data_ptr(),
        ACT_CODES[spec.activation],
        BINARY_CODES[spec.binary],
    )
