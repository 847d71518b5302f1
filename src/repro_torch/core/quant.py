"""Quantized weight tensors for the low-precision serving ladder (the port's
copy of ``repro.core.quant``, in torch).

A weight is stored as int8 values plus per-output-channel f32 scales
(symmetric, no zero point) and dequantized inside the GEMM kernels as a
fused epilogue stage:

    C = (A @ V) * s        # s broadcast over the N (output-channel) axis

which is exact algebra for per-output-channel scales, so the kernels read
the raw int8 weights (B moves 1 byte per element, half of bf16) and apply
``s`` once per output element at the DP flush or the Stream-K fix-up.

The ladder has three rungs below dense, as in ``repro``:

* ``bits=8``: int8 weights, float activations — ``"<act>*int8"``
  fingerprints.
* ``bits=8, act_bits=8``: int8 weights AND int8 activations quantized per
  row at dispatch (:func:`quantize_activations`); the kernels accumulate
  int8 x int8 in int32 and apply the rank-1 rescale ``s_a (x) s_b`` —
  ``"int8*int8"`` fingerprints.
* ``bits=4``: weights packed two nibbles per byte along K
  (:func:`pack_int4` / :func:`unpack_int4`), unpacked in the kernels'
  prologue, so B moves half a byte per element — ``"<act>*int4"``.

Layout: weights are ``(..., K, N)`` with the contraction axis second to
last; scales drop exactly the K axis (``values.shape[:-2] +
values.shape[-1:]``). For ``bits=4`` the stored K axis is the packed
``ceil(K/2)`` and :attr:`QuantizedTensor.shape` reports the logical K.

Rounding is ``torch.round`` (half to even, as ``jnp.round``), so codes and
scales are byte-identical to ``repro``'s for the same input.

Across ranks (a ranked plan, ``repro_torch.dist.sharding``) a weight leaf
is this rank's shard. Where the plan splits its K over mesh axes, each
column's amax is all-reduced with MAX over those axes before the scale is
taken, so every rank's codes and scales are ``repro``'s quantize-then-
shard, bit for bit; an int4 shard of K must hold whole nibble pairs. A
row-parallel int8-dynamic dispatch likewise takes each row's amax over
the whole row (:func:`quantize_activations`' ``axis``).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Tuple

import torch

log = logging.getLogger(__name__)

#: int8 symmetric range: +-127 (the -128 code is unused so the range is
#: symmetric and negation is exact).
_QMAX = 127.0

#: int4 symmetric range: +-7 (the -8 nibble is unused, mirroring int8).
_QMAX4 = 7.0

#: parameter-tree keys :func:`quantize_lm_params` converts: the dense
#: projection weights every model routes through ``core.gemm`` with a
#: (..., K, N) layout. Routers, norms and the embedding table stay full
#: precision.
QUANT_WEIGHT_NAMES = frozenset(
    {"wq", "wk", "wv", "wo", "w_in", "w_out", "w_gate", "lm_head"}
)


# ---------------------------------------------------------------------------
# int4 nibble packing (two values per byte along K)
# ---------------------------------------------------------------------------


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack an int8 tensor of int4-range values ``(..., K, N)`` into
    ``(..., ceil(K/2), N)`` bytes: even-k values in the low nibble, odd-k in
    the high nibble. Odd K zero-pads one trailing k row (exact for GEMM)."""
    if q.dim() < 2:
        raise ValueError(f"pack_int4 expects (..., K, N), got shape {tuple(q.shape)}")
    if q.shape[-2] % 2:
        q = torch.cat([q, q.new_zeros((*q.shape[:-2], 1, q.shape[-1]))], dim=-2)
    lo = q[..., 0::2, :].to(torch.int32) & 0xF
    hi = (q[..., 1::2, :].to(torch.int32) & 0xF) << 4
    # (lo | hi) spans 0..255; the uint8 view keeps the raw byte
    return (lo | hi).to(torch.uint8).view(torch.int8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: ``(..., K2, N)`` packed bytes ->
    ``(..., 2*K2, N)`` int8 values in [-8, 7] (each nibble sign-extended)."""
    p32 = p.to(torch.int32)
    lo = (p32 << 28) >> 28  # arithmetic shifts sign-extend each nibble
    hi = (p32 << 24) >> 28
    k2, n = p.shape[-2], p.shape[-1]
    return torch.stack([lo, hi], dim=-2).reshape(*p.shape[:-2], 2 * k2, n).to(torch.int8)


class QuantizedTensor:
    """Symmetric per-output-channel quantized weight.

    ``bits=8``: ``values`` (..., K, N) int8 + ``scales`` (..., N) f32.
    ``bits=4``: ``values`` (..., ceil(K/2), N) int8 — two nibbles per byte
    along K — with the logical contraction length ``k``. ``act_bits=8``
    requests dynamic per-row int8 activation quantization at dispatch.

    Indexing a leading axis (``q[i]``) slices values and scales together:
    the model walks its stacked ``(L, ...)`` layers that way."""

    def __init__(
        self,
        values: torch.Tensor,
        scales: torch.Tensor,
        *,
        bits: int = 8,
        act_bits: Optional[int] = None,
        k: Optional[int] = None,
    ):
        if bits not in (8, 4):
            raise ValueError(f"QuantizedTensor supports bits in (8, 4), got {bits}")
        if act_bits not in (None, 8):
            raise ValueError(f"act_bits must be None or 8, got {act_bits}")
        vs = tuple(values.shape)
        if len(vs) < 2:
            raise ValueError(
                f"QuantizedTensor values must be at least 2-D (..., K, N); got shape {vs}"
            )
        if bits == 4:
            if k is None:
                raise ValueError(
                    "bits=4 stores the packed ceil(K/2) axis; pass the logical "
                    "contraction length k="
                )
            if (k + 1) // 2 != vs[-2]:
                raise ValueError(
                    f"packed values K axis {vs[-2]} does not match ceil(k/2) for "
                    f"logical k={k}"
                )
        else:
            k = vs[-2]
        want = vs[:-2] + vs[-1:]
        if tuple(scales.shape) != want:
            raise ValueError(
                f"scale shape {tuple(scales.shape)} does not match values {vs}: "
                f"per-output-channel scales must drop exactly the contraction axis "
                f"-> expected {want}"
            )
        self.values = values
        self.scales = scales
        self.bits = int(bits)
        self.act_bits = act_bits
        self.k = int(k)

    @property
    def shape(self) -> Tuple[int, ...]:
        """LOGICAL weight shape (..., K, N): for ``bits=4`` K is the
        contraction length, not the packed axis."""
        vs = tuple(self.values.shape)
        return vs[:-2] + (self.k, vs[-1]) if self.bits == 4 else vs

    def dim(self) -> int:
        """Rank of the values (leading axes are shared with scales)."""
        return self.values.dim()

    @property
    def dtype(self) -> torch.dtype:
        """Storage dtype of the values (int8 bytes) — NOT the compute dtype."""
        return self.values.dtype

    @property
    def dtype_name(self) -> str:
        """Fingerprint dtype component: ``"int4"`` for packed nibbles, else
        ``"int8"``."""
        return "int4" if self.bits == 4 else "int8"

    @property
    def nbytes(self) -> int:
        """Bytes of values and scales."""
        return sum(t.numel() * t.element_size() for t in (self.values, self.scales))

    def __getitem__(self, idx) -> "QuantizedTensor":
        """Index the leading (stack or group) axes of values and scales."""
        if self.values.dim() < 3:
            raise IndexError("a 2-D QuantizedTensor has no leading axis to index")
        return QuantizedTensor(self.values[idx], self.scales[idx], bits=self.bits,
                               act_bits=self.act_bits, k=self.k if self.bits == 4 else None)

    def __repr__(self) -> str:
        return (
            f"QuantizedTensor(values={tuple(self.values.shape)}:{self.values.dtype}, "
            f"scales={tuple(self.scales.shape)}, bits={self.bits}"
            + (f", act_bits={self.act_bits}" if self.act_bits else "")
            + ")"
        )

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        """Dense reconstruction ``V * s`` (the reference the kernels are held
        against); ``bits=4`` unpacks and drops the zero row of an odd K."""
        v = self.values
        if self.bits == 4:
            v = unpack_int4(v)[..., : self.k, :]
        w = v.to(torch.float32) * self.scales[..., None, :].to(torch.float32)
        return w.to(dtype)


def is_quantized(x: Any) -> bool:
    """True iff ``x`` is a :class:`QuantizedTensor` weight leaf."""
    return isinstance(x, QuantizedTensor)


def _all_reduce_max(x: torch.Tensor, axes) -> torch.Tensor:
    if not axes:
        return x
    from repro_torch.dist.collectives import all_reduce_max

    return all_reduce_max(x, axes)


def _quantize_matrix(w: torch.Tensor, qmax: float, amax: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    wf = w.to(torch.float32)
    if amax is None:
        amax = wf.abs().amax(dim=-2)
    scales = torch.clamp_min(amax, 1e-8) / qmax
    q = torch.clamp(torch.round(wf / scales[..., None, :]), -qmax, qmax).to(torch.int8)
    return q, scales


def quantize_weight(
    w: torch.Tensor,
    *,
    axis: int = -2,
    bits: int = 8,
    act_bits: Optional[int] = None,
    k_axes: Tuple[str, ...] = (),
) -> QuantizedTensor:
    """Symmetric per-output-channel quantization of a (..., K, N) weight;
    ``axis`` is the contraction axis the scale reduces over. Round to
    nearest (half to even): the elementwise error is at most ``scale / 2``
    with ``scale = amax / qmax`` (qmax 127 for int8, 7 for int4).

    A stacked weight (ndim > 2) is quantized one leading slice at a time
    into preallocated outputs, so the f32 working copy is one matrix, not
    the whole stack (a (36, 4096, 14336) bf16 leaf would need 8.5 GB).

    ``k_axes``: the mesh axes over which the installed ranked plan splits
    this shard's K. The columns' amaxes of every slice are then all-reduced
    with MAX over them in one exchange before any slice is quantized."""
    if w.dim() < 2:
        raise ValueError(f"quantize_weight expects a matrix, got shape {tuple(w.shape)}")
    if axis % w.dim() != w.dim() - 2:
        raise ValueError(
            f"contraction axis must be -2 in the (..., K, N) layout; got axis {axis} "
            f"for shape {tuple(w.shape)}"
        )
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    qmax = _QMAX if bits == 8 else _QMAX4
    k, n = w.shape[-2:]
    rows = (k + 1) // 2 if bits == 4 else k
    lead = tuple(w.shape[:-2])
    values = torch.empty((*lead, rows, n), dtype=torch.int8, device=w.device)
    scales = torch.empty((*lead, n), dtype=torch.float32, device=w.device)
    flat_w = w.reshape(-1, k, n)
    flat_v, flat_s = values.view(-1, rows, n), scales.view(-1, n)
    amax = None
    if k_axes:
        amax = torch.stack([flat_w[i].abs().amax(dim=-2).to(torch.float32)
                            for i in range(flat_w.shape[0])])
        amax = _all_reduce_max(amax, k_axes)
    for i in range(flat_w.shape[0]):
        q, s = _quantize_matrix(flat_w[i], qmax, None if amax is None else amax[i])
        flat_v[i] = pack_int4(q) if bits == 4 else q
        flat_s[i] = s
    return QuantizedTensor(values, scales, bits=bits, act_bits=act_bits,
                           k=k if bits == 4 else None)


def quantize_activations(x: torch.Tensor, axis: Optional[str] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-row int8 activation quantization: ``x`` (..., K)
    float -> (int8 values of the same shape, f32 scales (...,)), the scale
    ``amax / 127`` over the contraction axis of each row. ``axis``: the
    mesh axis over which the ranks split K (a row-parallel dispatch); each
    row's amax is then all-reduced with MAX over it, so the scale is the
    whole row's."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    if axis is not None:
        amax = _all_reduce_max(amax, (axis,))
    scales = torch.clamp_min(amax, 1e-8) / _QMAX
    q = torch.clamp(torch.round(xf / scales[..., None]), -_QMAX, _QMAX).to(torch.int8)
    return q, scales


def quantize_lm_params(
    params: Dict[str, Any],
    names: frozenset = QUANT_WEIGHT_NAMES,
    *,
    bits: int = 8,
    act_bits: Optional[int] = None,
    specs: Optional[Dict[str, Any]] = None,
    plan=None,
) -> Tuple[Dict[str, Any], int, int]:
    """Weight quantization at model load (the serve CLI's ``--quantize``):
    every float leaf of ndim >= 2 under a key in ``names`` becomes a
    :class:`QuantizedTensor`, leaf by leaf; everything else is untouched.
    Returns (new tree, leaves quantized, float leaves skipped under a
    matching key). Dicts, lists and tuples are walked, as in ``repro``.

    Under a ranked ``plan`` the leaves are this rank's shards and ``specs``
    is the tree's ArraySpec tree (the weights' full specs): each leaf's K
    entry names the axes its amax is all-reduced over (module doc), and the
    installed plan must be ``plan``, whose ranks all call this together."""
    n_quantized = 0
    n_skipped = 0
    if plan is not None and specs is None:
        raise ValueError("quantizing a ranked plan's shards needs the weights' specs")

    def k_axes(spec) -> Tuple[str, ...]:
        if plan is None or spec is None:
            return ()
        from repro_torch.dist.sharding import axes_of, check_quant_layout

        parts = plan.spec_for(spec)
        if bits == 4:
            check_quant_layout(plan, spec, (spec.shape[-2] + 1) // 2)
        return tuple(a for a in axes_of(parts[-2]) if plan.mesh.shape[a] > 1)

    def walk(node, named: bool = False, spec=None):
        nonlocal n_quantized, n_skipped
        if isinstance(node, dict):
            return {key: walk(sub, named=key in names,
                              spec=None if spec is None else spec.get(key))
                    for key, sub in node.items()}
        if isinstance(node, (list, tuple)):
            walked = [walk(item, named=named) for item in node]
            if isinstance(node, tuple) and hasattr(node, "_fields"):
                return type(node)(*walked)  # namedtuple
            return type(node)(walked)
        if named and isinstance(node, torch.Tensor) and node.is_floating_point():
            if node.dim() >= 2:
                n_quantized += 1
                return quantize_weight(node, bits=bits, act_bits=act_bits,
                                       k_axes=k_axes(spec))
            n_skipped += 1
        return node

    out = walk(params, spec=specs)
    if n_skipped:
        log.warning(
            "quantize_lm_params skipped %d float leaf/leaves under quantizable keys "
            "(not eligible (..., K, N) projections) — they will be served dense",
            n_skipped,
        )
    return out, n_quantized, n_skipped
