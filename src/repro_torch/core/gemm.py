"""Public GEMM dispatch API (counterpart of ``repro.core.gemm``).

Every projection of the port's models routes through :func:`gemm`, which

  1. builds a :class:`~repro_torch.core.op.GemmOp` fingerprint (global and
     per-shard dims, dtypes, the fused epilogue),
  2. asks the context's :class:`~repro_torch.core.selector.KernelSelector`
     for a (policy, tile config, grid size) — tuned DB, then cross-arch
     seeds, then the Bloom sieve, then the cost model,
  3. runs the backend registered under the context's backend name.

Built-in backends:

  * ``torch`` — eager ``torch.matmul`` plus ``Epilogue.apply`` on the f32
    accumulator: the CPU oracle, counterpart of the JAX package's ``xla``;
  * ``cuda``  — the Stream-K++ composition of the hand-written Hopper
    kernels (``kernels/streamk/ops.py``), counterpart of ``pallas``; a fused
    grouped op runs as ONE launch of the grouped kernel
    (``kernels/streamk/grouped.py``). On CPU tensors its wrappers run their
    kernels' plain versions, the counterpart of ``pallas_interpret``.

Entry points: :func:`gemm` (2-D weight), :func:`gemm_grouped` (stacked
``(G, K, N)`` expert weights, fused into one kernel by default and keyed by
the 8-part ``grouped_fused`` op key; ``fused=False`` keeps one dispatch per
group as the differential oracle) and :func:`gemm_batched` (independent
per-batch operands of equal shape, always the loop form and the 7-part
key). Each takes a
:class:`~repro_torch.core.quant.QuantizedTensor` weight: the op then keys on
the mixed ``"<act>*int8"``/``"<act>*int4"`` fingerprint, or ``"int8*int8"``
when the weight asks for int8 activations, which are quantized per row
here at dispatch; the dequant scales ride into the backend.

When no backend is named, a dispatch on a CUDA tensor runs ``cuda`` and one
on a CPU tensor runs ``torch``: on the card the hand-written kernels are the
default, never a library matmul. The selector, when none is installed, is
:func:`~repro_torch.core.selector.default_selector` for the operands'
device (nominal H100 and the Hopper tiles on a CUDA device).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.core.op import Epilogue, GemmOp, as_epilogue
from repro_torch.core.policies import Policy, TileConfig
from repro_torch.core.quant import QuantizedTensor, is_quantized, quantize_activations, unpack_int4
from repro_torch.core.selector import KernelSelector, Selection, default_selector
from repro_torch.core.tuner import LEGACY_GRID

_state = threading.local()

#: BackendFn(x, w, *, op, policy, cfg, g, bias, operand[, scale, scale_a,
#:           b_bits]) -> out
#:   x: (G, M, K), w: (G, K, N), bias: (G, N) | None, operand: (G, M, N) | None;
#:   returns (G, M, N) in op.out_dtype. G == 1 for plain 2-D dispatches.
#:   Quantized ops also pass ``scale`` (G, N) f32, the per-output-channel
#:   dequant of the int8 ``w``; ``scale_a`` (G, M) f32, the per-row dequant
#:   of int8 ``x``; and ``b_bits=4`` when ``w`` is packed int4
#:   (G, ceil(K/2), N). Both apply to the f32 accumulator before the
#:   epilogue. Dense ops pass none of them, so a backend that predates them
#:   fails loudly on a quantized op instead of dropping a dequant stage.
BackendFn = Callable[..., torch.Tensor]

_BACKENDS: Dict[str, BackendFn] = {}


def register_backend(name: str, fn: BackendFn, *, overwrite: bool = False) -> None:
    """Register an execution backend under ``name`` (see BackendFn)."""
    if name in _BACKENDS and not overwrite:
        raise ValueError(f"backend {name!r} already registered")
    _BACKENDS[name] = fn


def list_backends() -> Tuple[str, ...]:
    """Registered backend names, sorted."""
    return tuple(sorted(_BACKENDS))


def get_backend(name: str) -> BackendFn:
    """Resolve a backend by name; raises with the valid names on a miss."""
    try:
        return _BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown gemm backend {name!r}; registered backends: {list(list_backends())}"
        ) from None


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def dtype_name(dtype: torch.dtype) -> str:
    """JAX-style dtype fingerprint (``torch.bfloat16`` -> ``"bfloat16"``), so
    op keys are byte-identical to the JAX package's."""
    return str(dtype).removeprefix("torch.")


def as_dtype(dtype) -> torch.dtype:
    """torch dtype from a torch dtype or a fingerprint name."""
    return dtype if isinstance(dtype, torch.dtype) else _DTYPES[str(dtype)]


def _torch_backend(x, w, *, op: GemmOp, policy, cfg, g, bias, operand, scale=None,
                   scale_a=None, b_bits=8):
    if b_bits == 4:
        # packed int4 weights: unpack to int8 and drop the odd-K pad row
        w = unpack_int4(w)[:, : x.shape[2], :]
    if not (x.is_floating_point() or w.is_floating_point()):
        # int8 x int8: an exact integer contraction, converted to f32, as
        # repro's xla backend does in int32. CUDA has no integer matmul, so
        # there it multiplies in float64, exact for any sum below 2**53.
        wide = torch.float64 if x.is_cuda else torch.int32
        acc = torch.matmul(x.to(wide), w.to(wide)).to(torch.float32)
    else:
        # float (or float x int8: int8 -> f32 is exact) in f32
        acc = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    if scale_a is not None:
        acc = acc * scale_a[:, :, None].to(torch.float32)
    if scale is not None:
        acc = acc * scale[:, None, :].to(torch.float32)
    acc = op.epilogue.apply(
        acc, bias=None if bias is None else bias[:, None, :], operand=operand
    )
    return acc.to(as_dtype(op.out_dtype))


def _cuda_backend(x, w, *, op: GemmOp, policy, cfg, g, bias, operand, scale=None,
                  scale_a=None, b_bits=8):
    from repro_torch.kernels.streamk import ops as sk_ops
    from repro_torch.kernels.streamk.grouped import gemm_grouped_streamk

    if op.fused:
        # one launch spans the concatenated tile space of all G groups
        return gemm_grouped_streamk(
            x, w, policy=policy, cfg=cfg, g=g, out_dtype=as_dtype(op.out_dtype),
            epilogue=op.epilogue, bias=bias, operand=operand, scale=scale, scale_a=scale_a,
            b_bits=b_bits,
        )
    # loop form: the policy composition once per group (the fused form's
    # differential oracle, and every plain 2-D dispatch)
    outs = [
        sk_ops.gemm(
            x[i],
            w[i],
            policy=policy,
            cfg=cfg,
            g=g,
            out_dtype=as_dtype(op.out_dtype),
            epilogue=op.epilogue,
            bias=None if bias is None else bias[i],
            operand=None if operand is None else operand[i],
            scale=None if scale is None else scale[i],
            scale_a=None if scale_a is None else scale_a[i],
            b_bits=b_bits,
        )
        for i in range(x.shape[0])
    ]
    return outs[0][None] if len(outs) == 1 else torch.stack(outs)


register_backend("torch", _torch_backend)
register_backend("cuda", _cuda_backend)


@dataclass
class SelectionLogEntry:
    """One dispatch decision: the op fingerprint, what was selected, and the
    caller's tag (e.g. ``"mlp.in"``)."""

    op: GemmOp
    selection: Selection
    tag: str = ""

    @property
    def global_mnk(self) -> Tuple[int, int, int]:
        """Unsharded problem dims of the logged op."""
        return self.op.global_mnk

    @property
    def local_mnk(self) -> Tuple[int, int, int]:
        """Per-shard local dims of the logged op."""
        return self.op.local


@dataclass
class GemmContext:
    """Ambient dispatch state: selector (None = the device's default, made
    at first dispatch), backend name (None = by device), and the log."""

    selector: Optional[KernelSelector] = None
    backend: Optional[str] = None
    log: List[SelectionLogEntry] = field(default_factory=list)


def _ctx() -> GemmContext:
    ctx = getattr(_state, "ctx", None)
    if ctx is None:
        ctx = _state.ctx = GemmContext()
    return ctx


@contextmanager
def gemm_context(
    selector: Optional[KernelSelector] = None,
    backend: Optional[str] = None,
    device=None,
):
    """Install a dispatch context for the duration of a block.

    ``backend="cuda"`` needs a CUDA device: without one it raises unless the
    caller passes ``device="cpu"``, which runs the kernels' plain versions
    on CPU tensors."""
    if backend is not None:
        get_backend(backend)  # fail fast on unknown names
    if backend == "cuda" and device is None and not torch.cuda.is_available():
        raise RuntimeError(
            "the cuda backend needs a CUDA device; pass device='cpu' to run "
            "its kernels' plain versions on CPU tensors"
        )
    old = getattr(_state, "ctx", None)
    base = old or _ctx()
    _state.ctx = GemmContext(
        selector=selector if selector is not None else base.selector,
        backend=backend if backend is not None else base.backend,
    )
    try:
        yield _state.ctx
    finally:
        _state.ctx = old


def current_selector(device=None) -> KernelSelector:
    """The active context's selector, made for ``device`` on first use."""
    ctx = _ctx()
    if ctx.selector is None:
        ctx.selector = default_selector(device)
    return ctx.selector


def _dispatch(x, w, op: GemmOp, *, tag, policy, cfg, g, bias, operand, scale=None,
              scale_a=None, b_bits=8):
    ctx = _ctx()
    selector = current_selector(x.device)
    if policy is None and cfg is None and g is None:
        sel = selector.select_op(op)
    elif policy is not None and cfg is not None:
        sel = selector.record_forced(op, policy, cfg, g=g if g is not None else LEGACY_GRID)
    else:
        sel = selector.select_partial(op, policy, cfg, g=g)
    ctx.log.append(SelectionLogEntry(op, sel, tag))
    name = ctx.backend or ("cuda" if x.is_cuda else "torch")
    kwargs = dict(op=op, policy=sel.policy, cfg=sel.cfg, g=sel.g, bias=bias, operand=operand)
    # only quantized ops pass the dequant operands (see BackendFn)
    if scale is not None:
        kwargs["scale"] = scale
    if scale_a is not None:
        kwargs["scale_a"] = scale_a
    if b_bits != 8:
        kwargs["b_bits"] = b_bits
    return get_backend(name)(x, w, **kwargs)


def _infer_epilogue(epilogue, bias, operand) -> Epilogue:
    """Normalise the epilogue argument and cross-check it against the
    supplied operands."""
    if epilogue is None and (bias is not None or operand is not None):
        raise ValueError(
            "bias/operand supplied without an epilogue spec; pass "
            "epilogue=Epilogue(bias=..., binary=...)"
        )
    spec = as_epilogue(epilogue)
    if spec.bias != (bias is not None):
        raise ValueError(
            f"epilogue {spec.name!r} expects bias={spec.bias} but bias operand is "
            f"{'missing' if bias is None else 'present'}"
        )
    if (spec.binary != "none") != (operand is not None):
        raise ValueError(
            f"epilogue {spec.name!r} expects "
            f"{'an' if spec.binary != 'none' else 'no'} binary operand"
        )
    return spec


def _in_dtype_fingerprint(x: torch.Tensor, w: torch.Tensor, w_name: Optional[str] = None) -> str:
    """Input-dtype component of the op key: one name when activations and
    weights agree, the mixed ``"a*w"`` form otherwise. Quantized weights
    pass their logical ``w_name`` (``"int8"``/``"int4"``) and always key in
    the mixed form, so ``"int8*int8"`` never collides with a plain int8 op
    (as the JAX package)."""
    xd = dtype_name(x.dtype)
    if w_name is not None:
        return f"{xd}*{w_name}"
    wd = dtype_name(w.dtype)
    return xd if xd == wd else f"{xd}*{wd}"


def _unquantize(w):
    """(stored weight, logical shape, scale, b_bits, w_name, act_quant) of a
    weight that may be a QuantizedTensor."""
    if is_quantized(w):
        return w.values, w.shape, w.scales, w.bits, w.dtype_name, w.act_bits == 8
    return w, tuple(w.shape), None, 8, None, False


def gemm(
    x: torch.Tensor,
    w: Union[torch.Tensor, QuantizedTensor],
    *,
    divisors: Tuple[int, int, int] = (1, 1, 1),
    out_dtype=None,
    tag: str = "",
    policy: Optional[Policy] = None,
    cfg: Optional[TileConfig] = None,
    g: Optional[int] = None,
    epilogue: Union[None, str, Epilogue] = None,
    bias: Optional[torch.Tensor] = None,
    operand: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``x @ w`` with Stream-K++ kernel selection.

    x: (..., K); w: (K, N) -> (..., N). ``divisors`` are the sharding
    factors (dm, dn, dk) so selection keys on the per-shard local shape.
    ``epilogue`` fuses bias/activation/binary post-ops (``bias``: (N,),
    ``operand``: (..., N)). ``policy``/``cfg``/``g`` override selection.
    ``w`` may be a :class:`~repro_torch.core.quant.QuantizedTensor` (see the
    module docstring); the output dtype defaults to ``x``'s own, also when
    the activations are quantized to int8 here."""
    w, w_shape, scale, bits, w_name, act_quant = _unquantize(w)
    if len(w_shape) != 2 or x.shape[-1] != w_shape[0]:
        raise ValueError(f"gemm contraction mismatch: {tuple(x.shape)} @ {w_shape}")
    epilogue = _infer_epilogue(epilogue, bias, operand)
    lead = x.shape[:-1]
    m = 1
    for d in lead:
        m *= int(d)
    k, n = int(w_shape[0]), int(w_shape[1])
    # the output dtype comes from the ORIGINAL activations
    out_dtype = as_dtype(out_dtype) if out_dtype is not None else x.dtype
    scale_a = None
    if act_quant and x.is_floating_point():
        x, scale_a = quantize_activations(x)
        scale_a = scale_a.reshape(1, m)
    op = GemmOp(
        m,
        n,
        k,
        in_dtype=_in_dtype_fingerprint(x, w, w_name=w_name),
        out_dtype=dtype_name(out_dtype),
        divisors=tuple(divisors),
        epilogue=epilogue,
    )
    out = _dispatch(
        x.reshape(1, m, k).contiguous(),
        w[None],
        op,
        tag=tag,
        policy=policy,
        cfg=cfg,
        g=g,
        bias=None if bias is None else bias.reshape(1, n),
        operand=None if operand is None else operand.reshape(1, m, n).contiguous(),
        scale=None if scale is None else scale.reshape(1, n),
        scale_a=scale_a,
        b_bits=bits,
    )
    return out.reshape(*lead, n)


def gemm_grouped(
    x: torch.Tensor,
    w: Union[torch.Tensor, QuantizedTensor],
    *,
    divisors: Tuple[int, int, int] = (1, 1, 1),
    g_divisor: int = 1,
    out_dtype=None,
    tag: str = "",
    policy: Optional[Policy] = None,
    cfg: Optional[TileConfig] = None,
    grid: Optional[int] = None,
    epilogue: Union[None, str, Epilogue] = None,
    bias: Optional[torch.Tensor] = None,
    operand: Optional[torch.Tensor] = None,
    fused: bool = True,
) -> torch.Tensor:
    """Grouped GEMM over stacked weights: x (G, M, K) @ w (G, K, N) ->
    (G, M, N), the MoE expert shape (G experts, M = expert capacity).

    One selection covers all groups; the op fingerprint records ``G`` and
    ``g_divisor`` (the expert-parallel factor). ``bias``: (G, N) or (N,);
    ``operand``: (G, M, N). ``grid`` overrides the selected grid size.
    ``fused`` (default True) runs the G groups as ONE kernel and keys the op
    with the 8-part ``grouped_fused`` key; ``fused=False`` runs them one by
    one (the differential oracle). ``w`` may be a stacked
    :class:`~repro_torch.core.quant.QuantizedTensor` (values (G, K, N) or
    packed (G, ceil(K/2), N), scales (G, N)): the MoE expert weights of the
    quantized serving path."""
    return _gemm_stacked(
        "grouped", x, w, divisors=divisors, g_divisor=g_divisor, out_dtype=out_dtype, tag=tag,
        policy=policy, cfg=cfg, grid=grid, epilogue=epilogue, bias=bias, operand=operand,
        fused=fused,
    )


def gemm_batched(
    x: torch.Tensor,
    w: Union[torch.Tensor, QuantizedTensor],
    *,
    divisors: Tuple[int, int, int] = (1, 1, 1),
    g_divisor: int = 1,
    out_dtype=None,
    tag: str = "",
    policy: Optional[Policy] = None,
    cfg: Optional[TileConfig] = None,
    grid: Optional[int] = None,
    epilogue: Union[None, str, Epilogue] = None,
    bias: Optional[torch.Tensor] = None,
    operand: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Batched GEMM: x (B, M, K) @ w (B, K, N) -> (B, M, N), independent
    per-batch operands of equal shape (one selection covers the batch). It
    always runs the loop form: the policy composition once per batch entry,
    keyed by the 7-part op key (``repro.core.gemm.gemm_batched``)."""
    return _gemm_stacked(
        "batched", x, w, divisors=divisors, g_divisor=g_divisor, out_dtype=out_dtype, tag=tag,
        policy=policy, cfg=cfg, grid=grid, epilogue=epilogue, bias=bias, operand=operand,
    )


def _gemm_stacked(
    kind: str,
    x: torch.Tensor,
    w: Union[torch.Tensor, QuantizedTensor],
    *,
    divisors: Tuple[int, int, int],
    g_divisor: int,
    out_dtype,
    tag: str,
    policy: Optional[Policy],
    cfg: Optional[TileConfig],
    grid: Optional[int],
    epilogue: Union[None, str, Epilogue],
    bias: Optional[torch.Tensor],
    operand: Optional[torch.Tensor],
    fused: bool = False,
) -> torch.Tensor:
    w, w_shape, scale, bits, w_name, act_quant = _unquantize(w)
    if x.dim() != 3 or len(w_shape) != 3:
        raise ValueError(
            f"gemm_{kind} expects x (G, M, K) and w (G, K, N); got "
            f"{tuple(x.shape)} @ {w_shape}"
        )
    if x.shape[0] != w_shape[0] or x.shape[2] != w_shape[1]:
        raise ValueError(f"gemm_{kind} mismatch: {tuple(x.shape)} @ {w_shape}")
    epilogue = _infer_epilogue(epilogue, bias, operand)
    g, m, k = (int(d) for d in x.shape)
    n = int(w_shape[2])
    # the output dtype comes from the ORIGINAL activations
    out_dtype = as_dtype(out_dtype) if out_dtype is not None else x.dtype
    scale_a = None
    if act_quant and x.is_floating_point():
        x, scale_a = quantize_activations(x)  # scales (G, M)
    op = GemmOp(
        m,
        n,
        k,
        g=g,
        kind=kind,
        in_dtype=_in_dtype_fingerprint(x, w, w_name=w_name),
        out_dtype=dtype_name(out_dtype),
        divisors=tuple(divisors),
        g_divisor=g_divisor,
        epilogue=epilogue,
        fused=fused,
    )
    if bias is not None and bias.dim() == 1:
        bias = bias[None].expand(g, n)
    return _dispatch(
        x.contiguous(),
        w.contiguous(),
        op,
        tag=tag,
        policy=policy,
        cfg=cfg,
        g=grid,
        bias=None if bias is None else bias.contiguous(),
        operand=None if operand is None else operand.contiguous(),
        scale=scale,
        scale_a=scale_a,
        b_bits=bits,
    )
