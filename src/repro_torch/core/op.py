"""First-class GEMM operator spec — the dispatch key of Stream-K++ selection
(the port's copy of ``repro.core.op``; :meth:`Epilogue.apply` runs on torch
tensors).

The paper keys its tuned database and Bloom filters on a bare ``(M, N, K)``.
That covers dense 2-D projections but not the shapes a serving stack
actually runs: grouped MoE expert GEMMs (stacked ``(G, K, N)`` weights),
batched GEMMs, mixed dtypes, and activation epilogues fused into the
kernel's flush/fix-up phase. ``GemmOp`` captures the full problem
fingerprint; everything downstream (selector cache, tuning database, Bloom
encoding) keys on it, so grouped and fused variants tune and prune
independently — the "easy adaptation to new problem sizes ... or additional
tuning parameters" extension point the paper calls out.

Key compatibility: a *plain* op (one group, default epilogue) encodes to the
paper's original ``encode_mnk`` bytes and keys as the legacy ``(M, N, K)``
tuple, so tuning artifacts produced for the 2-D path keep working unchanged.

Grouped op forms: a grouped op may dispatch as a *per-group loop* (one
kernel launch per expert group — the original backend) or *fused* (one
persistent-grid kernel spanning the concatenated tile space of all groups,
``fused=True``). The two execute differently enough that they must tune,
journal, Bloom-prune and federate separately, so a fused op keys on the
8-part extended tuple ending in the :data:`GROUPED_FUSED_MARKER`. Legacy
journal/database artifacts carry only 3- and 7-part keys: they parse
unchanged and keep matching exactly the loop-form ops they were tuned for —
an old G-keyed record never leaks onto the fused path (or vice versa).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core.bloom import encode_mnk

_ACTIVATIONS = ("none", "relu", "gelu", "silu", "square")
_BINARIES = ("none", "mul_silu", "add")


@dataclass(frozen=True)
class Epilogue:
    """Fused post-accumulation epilogue, applied to the f32 accumulator
    before the final cast/store (zero extra HBM passes):

      1. ``bias``       — add a per-output-column bias vector,
      2. ``activation`` — unary activation (relu/gelu/silu/square),
      3. ``binary``     — combine with a second pre-computed operand:
           * ``mul_silu`` : ``acc * silu(operand)`` (the swiglu gate-mul),
           * ``add``      : ``acc + operand``       (residual add).
    """

    activation: str = "none"
    bias: bool = False
    binary: str = "none"

    def __post_init__(self):
        if self.activation not in _ACTIVATIONS:
            raise ValueError(
                f"unknown activation {self.activation!r}; valid: {_ACTIVATIONS}"
            )
        if self.binary not in _BINARIES:
            raise ValueError(
                f"unknown binary epilogue {self.binary!r}; valid: {_BINARIES}"
            )

    @property
    def is_none(self) -> bool:
        """True iff every stage is disabled (the identity epilogue)."""
        return self.activation == "none" and not self.bias and self.binary == "none"

    @property
    def name(self) -> str:
        """Canonical fingerprint string, e.g. ``bias+gelu`` / ``mul_silu``."""
        parts = []
        if self.bias:
            parts.append("bias")
        if self.activation != "none":
            parts.append(self.activation)
        if self.binary != "none":
            parts.append(self.binary)
        return "+".join(parts) if parts else "none"

    def apply(self, acc, *, bias=None, operand=None):
        """Reference semantics on an f32 accumulator (backends and kernels
        must match this). ``gelu`` is the tanh approximation, as
        ``jax.nn.gelu``'s default in the JAX package."""
        if self.bias:
            if bias is None:
                raise ValueError(f"epilogue {self.name} requires a bias operand")
            acc = acc + bias.to(torch.float32)
        if self.activation == "relu":
            acc = torch.clamp_min(acc, 0.0)
        elif self.activation == "gelu":
            acc = F.gelu(acc, approximate="tanh")
        elif self.activation == "silu":
            acc = F.silu(acc)
        elif self.activation == "square":
            acc = torch.square(torch.clamp_min(acc, 0.0))
        if self.binary != "none":
            if operand is None:
                raise ValueError(f"epilogue {self.name} requires an operand")
            opf = operand.to(torch.float32)
            if self.binary == "mul_silu":
                acc = acc * F.silu(opf)
            else:  # "add"
                acc = acc + opf
        return acc


#: the do-nothing epilogue
EPILOGUE_NONE = Epilogue()


def as_epilogue(epilogue: Union[None, str, Epilogue]) -> Epilogue:
    """Normalise None / legacy activation string / Epilogue to Epilogue."""
    if epilogue is None:
        return EPILOGUE_NONE
    if isinstance(epilogue, Epilogue):
        return epilogue
    return Epilogue(activation=epilogue)


#: op-form marker appended to the key of a fused grouped op (single
#: persistent-grid kernel over the concatenated group tile space); its
#: presence is what separates fused records from loop-form grouped records.
GROUPED_FUSED_MARKER = "grouped_fused"

#: selector/db key: legacy (M, N, K) for plain ops, the extended tuple
#: (M, N, K, G, in_dtype, out_dtype, epilogue_name) for grouped/batched/
#: fused-epilogue ops, or the 8-part form with the trailing
#: ``GROUPED_FUSED_MARKER`` for single-kernel fused grouped ops.
OpKey = Union[
    Tuple[int, int, int],
    Tuple[int, int, int, int, str, str, str],
    Tuple[int, int, int, int, str, str, str, str],
]


@dataclass(frozen=True)
class GemmOp:
    """Full fingerprint of one GEMM dispatch.

    ``m, n, k`` are *global* logical dims; ``divisors`` (and ``g_divisor``
    for the group dim) are the GSPMD sharding factors, so ``local`` is the
    per-shard problem the MXU actually sees — which is what selection keys
    on. ``g`` counts groups/batches: stacked expert weights ``(G, K, N)``
    dispatch as one op with ``g = G``.

    ``fused`` marks the single-kernel grouped op form: the pallas backend
    lowers all G groups in ONE persistent-grid ``pallas_call`` over the
    concatenated tile space instead of one launch per group. It is a real
    dispatch-behaviour axis, so it is part of the fingerprint (8-part key,
    see :data:`GROUPED_FUSED_MARKER`); ``fused=False`` (the default for
    directly constructed ops) keys identically to pre-fusion artifacts.
    """

    m: int
    n: int
    k: int
    g: int = 1
    kind: str = "plain"  # "plain" | "grouped" | "batched"
    in_dtype: str = "float32"
    out_dtype: str = "float32"
    divisors: Tuple[int, int, int] = (1, 1, 1)
    g_divisor: int = 1
    epilogue: Epilogue = field(default_factory=Epilogue)
    fused: bool = False

    def __post_init__(self):
        if self.kind not in ("plain", "grouped", "batched"):
            raise ValueError(f"unknown GemmOp kind {self.kind!r}")
        if self.kind == "plain" and self.g != 1:
            raise ValueError("plain ops have g == 1; use gemm_grouped/batched")
        if self.fused and self.kind != "grouped":
            raise ValueError(
                f"fused is the grouped single-kernel op form; kind={self.kind!r}"
            )

    # -- shapes ------------------------------------------------------------
    @property
    def global_mnk(self) -> Tuple[int, int, int]:
        """Unsharded logical problem dims."""
        return (self.m, self.n, self.k)

    @property
    def local(self) -> Tuple[int, int, int]:
        """Per-shard dims after dividing out the GSPMD sharding factors."""
        dm, dn, dk = self.divisors
        return (
            max(1, self.m // dm),
            max(1, self.n // dn),
            max(1, self.k // dk),
        )

    @property
    def g_local(self) -> int:
        """Groups per shard after expert-parallel sharding."""
        return max(1, self.g // self.g_divisor)

    @property
    def mnk_compatible(self) -> bool:
        """Shape-only op (one group, no epilogue): may *consult* tuning
        artifacts keyed on a bare (M, N, K), whatever its dtypes — the
        paper's databases/sieves are dtype-agnostic."""
        return (
            self.g_local == 1
            and self.kind == "plain"
            and self.epilogue.is_none
        )

    @property
    def is_plain(self) -> bool:
        """Keys/encodes identically to the paper's 2-D (M, N, K) path.

        Restricted to the canonical f32->f32 case: a bare (M, N, K) key
        carries no dtype, so only the default-dtype op may claim it as its
        *own* key — otherwise same-shape ops of different dtypes would
        silently overwrite each other's tuning records. Non-f32 shape-only
        ops still read MNK artifacts via :attr:`mnk_compatible` fallback
        in the selector."""
        return (
            self.mnk_compatible
            and self.in_dtype == "float32"
            and self.out_dtype == "float32"
        )

    # -- keys --------------------------------------------------------------
    @property
    def key(self) -> OpKey:
        """Selector/database key: the narrowest form that is still exact."""
        m, n, k = self.local
        if self.is_plain:
            return (m, n, k)
        base = (m, n, k, self.g_local, self.in_dtype, self.out_dtype, self.epilogue.name)
        if self.fused:
            return base + (GROUPED_FUSED_MARKER,)
        return base

    def encode(self) -> bytes:
        """Canonical byte encoding of :attr:`key` (Bloom-filter probe key)."""
        return encode_key(self.key)

    # -- constructors ------------------------------------------------------
    @classmethod
    def plain(
        cls,
        m: int,
        n: int,
        k: int,
        *,
        divisors: Tuple[int, int, int] = (1, 1, 1),
        in_dtype: str = "float32",
        out_dtype: Optional[str] = None,
        epilogue: Union[None, str, Epilogue] = None,
    ) -> "GemmOp":
        """Build a 2-D (single-group) op — the paper's original surface."""
        return cls(
            int(m),
            int(n),
            int(k),
            in_dtype=in_dtype,
            out_dtype=out_dtype or in_dtype,
            divisors=divisors,
            epilogue=as_epilogue(epilogue),
        )


def encode_key(key: OpKey) -> bytes:
    """Canonical Bloom-filter bytes for an op key.

    3-tuples use the paper's original ``encode_mnk`` layout so pre-existing
    filters/databases built from bare problem sizes remain valid; extended
    keys append group count and dtype/epilogue fingerprints, and the fused
    grouped form additionally appends its op-form marker — so loop and
    fused records of the same shape never collide in a Bloom filter.
    """
    if len(key) == 3:
        return encode_mnk(*key)
    m, n, k, g = key[:4]
    tail = "|".join(str(part) for part in key[4:]).encode()
    return struct.pack("<4q", m, n, k, g) + tail


def key_to_str(key: OpKey) -> str:
    """JSON-safe key serialization (legacy "m,n,k" format preserved)."""
    return ",".join(str(x) for x in key)


def key_from_str(s: str) -> OpKey:
    """Inverse of :func:`key_to_str` for all three key generations.

    Legacy 3-part ``"m,n,k"`` and 7-part grouped/fused-epilogue keys parse
    exactly as they always did (and so keep dispatching the op forms they
    were tuned for — the per-group loop path for grouped records); 8-part
    keys carry the fused-grouped op-form marker."""
    parts = s.split(",")
    if len(parts) == 3:
        return tuple(int(x) for x in parts)  # type: ignore[return-value]
    if len(parts) not in (7, 8):
        raise ValueError(f"malformed op key {s!r}")
    m, n, k, g = (int(x) for x in parts[:4])
    return (m, n, k, g, *parts[4:])
