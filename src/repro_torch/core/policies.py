"""Stream-K++ scheduling policies (the port's copy of ``repro.core.policies``,
plus the Hopper tile set).

The paper expands Stream-K's three schedules to seven distinct policies:

  * ``ALL_SK``          — Algorithm 1: the whole flattened MAC-iteration space
                          is split evenly across ``g`` workgroups.
  * ``HYBRID(b)``, b=1..6 — ``b`` Stream-K *batches* scheduled FIRST (so their
                          fix-up latency overlaps the data-parallel phase),
                          followed by conventional data-parallel tile waves
                          for the remaining output tiles.

``DP`` (zero Stream-K batches) is the conventional data-parallel baseline the
paper compares against; it is selectable but is not one of the seven
Stream-K++ policies.

A "batch" is one round of ``g`` workgroup-sized work quanta (Fig. 1 / §3.2 of
the paper): HYBRID(1) covers the quantized remainder wave Stream-K-style,
HYBRID(b>1) additionally converts ``b-1`` full tile waves into Stream-K work.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Tuple


class PolicyKind(enum.Enum):
    """The three schedule families: DP baseline, ALL_SK, HYBRID."""

    DP = "dp"
    ALL_SK = "all_sk"
    HYBRID = "hybrid"


@dataclass(frozen=True, order=True)
class Policy:
    """A Stream-K++ scheduling policy.

    ``sk_batches`` is meaningful only for ``HYBRID``; by convention we store
    0 for DP and -1 for ALL_SK so that policies order naturally.
    """

    kind: PolicyKind
    sk_batches: int = 0

    def __post_init__(self):
        if self.kind == PolicyKind.HYBRID and not (1 <= self.sk_batches <= 6):
            raise ValueError(f"HYBRID requires 1..6 sk_batches, got {self.sk_batches}")
        if self.kind == PolicyKind.DP and self.sk_batches != 0:
            raise ValueError("DP has no Stream-K batches")
        if self.kind == PolicyKind.ALL_SK and self.sk_batches != -1:
            raise ValueError("ALL_SK must use sk_batches=-1 sentinel")

    @property
    def name(self) -> str:
        """Canonical artifact name: ``dp`` / ``all_sk`` / ``sk{b}dp``."""
        if self.kind == PolicyKind.DP:
            return "dp"
        if self.kind == PolicyKind.ALL_SK:
            return "all_sk"
        return f"sk{self.sk_batches}dp"

    @property
    def is_streamk(self) -> bool:
        """True for the seven Stream-K++ policies (everything but DP)."""
        return self.kind != PolicyKind.DP

    def __str__(self) -> str:  # pragma: no cover - repr sugar
        return self.name


DP = Policy(PolicyKind.DP, 0)
ALL_SK = Policy(PolicyKind.ALL_SK, -1)
HYBRIDS: Tuple[Policy, ...] = tuple(
    Policy(PolicyKind.HYBRID, b) for b in range(1, 7)
)

#: The seven Stream-K++ policies of the paper.
STREAMKPP_POLICIES: Tuple[Policy, ...] = (ALL_SK,) + HYBRIDS

#: Everything the dispatcher may choose between (baseline included).
ALL_POLICIES: Tuple[Policy, ...] = (DP,) + STREAMKPP_POLICIES

_BY_NAME = {p.name: p for p in ALL_POLICIES}


def policy_from_name(name: str) -> Policy:
    """Inverse of :attr:`Policy.name` (artifact deserialisation)."""
    try:
        return _BY_NAME[name]
    except KeyError:
        raise ValueError(f"unknown policy {name!r}; valid: {sorted(_BY_NAME)}") from None


@dataclass(frozen=True, order=True)
class TileConfig:
    """MXU-aligned output/reduction tile sizes (BlockSpec shapes).

    TPU adaptation: the lane dimension is 128-wide and the MXU is a 128x128
    systolic array, so BN and BK are multiples of 128 and BM a multiple of 8
    (sublane granularity for f32 accumulators).
    """

    bm: int = 128
    bn: int = 128
    bk: int = 128

    def __post_init__(self):
        if self.bm % 8 or self.bn % 128 or self.bk % 128:
            raise ValueError(f"misaligned tile config {self}")

    @property
    def name(self) -> str:
        """Canonical artifact name, e.g. ``256x128x128``."""
        return f"{self.bm}x{self.bn}x{self.bk}"

    def vmem_bytes(
        self,
        in_dtype_bytes: int = 2,
        acc_dtype_bytes: int = 4,
        b_dtype_bytes: int | None = None,
    ) -> int:
        """Working-set claim: A tile + B tile + accumulator (double-buffered
        inputs, matching the pipelined BlockSpec the kernels use).
        ``b_dtype_bytes`` lets mixed activation x weight ops claim distinct
        A/B widths; it defaults to ``in_dtype_bytes``."""
        a = self.bm * self.bk * in_dtype_bytes
        b = self.bk * self.bn * (
            b_dtype_bytes if b_dtype_bytes is not None else in_dtype_bytes
        )
        acc = self.bm * self.bn * acc_dtype_bytes
        return 2 * (a + b) + acc


#: Candidate tile configs swept by the tuner (all fit comfortably in the
#: ~16 MiB v5e VMEM budget per TileConfig.vmem_bytes).
#:
#: Tile arithmetic intensity is bm*bn/(bm+bn) FLOP/byte vs. the v5e ridge
#: point of 240 (197 TFLOP/s / 819 GB/s): 512x512 tiles (intensity 256) are
#: compute-bound, 256x256 (128) and below are HBM-bound — the sweep spans
#: both regimes plus skinny-M decode shapes.
DEFAULT_TILE_CONFIGS: Tuple[TileConfig, ...] = (
    TileConfig(128, 128, 128),
    TileConfig(256, 128, 128),
    TileConfig(128, 256, 128),
    TileConfig(256, 256, 128),
    TileConfig(512, 256, 128),
    TileConfig(256, 512, 128),
    TileConfig(512, 512, 128),
    TileConfig(512, 512, 256),
    TileConfig(64, 128, 256),
    TileConfig(128, 128, 512),
    TileConfig(8, 128, 512),
    TileConfig(8, 256, 1024),
)

#: Candidate tile configs for an NVIDIA Hopper card (H100). A block's shared
#: memory (232,448 bytes) takes the place of VMEM, and most TPU tiles above
#: overflow it: at f32 every one of them does. The set keeps the TPU
#: alignment (bn, bk multiples of 128, bm of 8) so one ``TileConfig`` type
#: serves both packages; at f32 the 8/16/32/64 x128x128 tiles fit (64x128x128
#: claims 229,376 bytes), at bf16 all of them do. The 8- and 16-row tiles
#: are the skinny-M decode shapes (M = the serving slot count).
HOPPER_TILE_CONFIGS: Tuple[TileConfig, ...] = (
    TileConfig(8, 128, 128),
    TileConfig(16, 128, 128),
    TileConfig(32, 128, 128),
    TileConfig(64, 128, 128),
    TileConfig(128, 128, 128),
    TileConfig(8, 256, 128),
    TileConfig(64, 256, 128),
    TileConfig(8, 128, 256),
)
