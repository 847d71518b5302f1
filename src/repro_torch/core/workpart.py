"""Work-centric GEMM partitioning (Algorithm 1 of the paper, generalised to
the seven Stream-K++ policies) — the port's copy of ``repro.core.workpart``.

All of this is *static* integer math over (M, N, K, tile config, grid size,
policy): given those, every workgroup's iteration range, every tile's set of
contributing workgroups, and the fix-up plan are fully determined at trace /
compile time. That is what lets the TPU adaptation replace GPU atomics with a
deterministic two-phase reduction — the fix-up schedule is a compile-time
constant table, not a runtime discovery.

Glossary (matches Algorithm 1):
  iters_per_tile = ceil(K / BK)           (k-iterations per output tile)
  total_iters    = n_tiles * iters_per_tile
  g              = grid size (number of persistent workgroups / Pallas
                   programs); on TPU this is the virtual-lane count.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import cached_property
from typing import List, Tuple

from repro_torch.core.policies import ALL_SK, DP, Policy, PolicyKind, TileConfig


def cdiv(a: int, b: int) -> int:
    """Ceiling division (number of size-``b`` tiles covering ``a``)."""
    return -(-a // b)


@dataclass(frozen=True)
class GemmShape:
    """One GEMM problem size (local / per-shard dims the kernel executes)."""

    m: int
    n: int
    k: int

    def __post_init__(self):
        if min(self.m, self.n, self.k) < 1:
            raise ValueError(f"degenerate GEMM shape {self}")

    @property
    def flops(self) -> int:
        """True MAC FLOPs of the problem (2*M*N*K)."""
        return 2 * self.m * self.n * self.k

    def key(self) -> Tuple[int, int, int]:
        """Legacy (M, N, K) tuple form."""
        return (self.m, self.n, self.k)


@dataclass(frozen=True)
class GroupedGemmShape(GemmShape):
    """``groups`` same-shape GEMMs executed as ONE fused kernel over the
    concatenated tile space (the grouped Stream-K op form).

    Subclassing :class:`GemmShape` keeps every existing signature —
    ``partition_stats``, the cost model, ``MeasureFn`` — unchanged: code
    that does not care about groups sees a plain shape, and groups-aware
    code reads ``getattr(shape, "groups", 1)``. Distinct type identity
    (dataclass ``__eq__`` is class-strict) keeps fused and per-group
    entries separate in the cost model's memo cache.
    """

    groups: int = 1

    def __post_init__(self):
        super().__post_init__()
        if self.groups < 1:
            raise ValueError(f"grouped shape needs groups >= 1, got {self.groups}")

    @property
    def flops(self) -> int:
        """True FLOPs across all groups (groups * 2*M*N*K)."""
        return self.groups * 2 * self.m * self.n * self.k


@dataclass(frozen=True)
class WorkRange:
    """A contiguous range of flattened MAC iterations owned by one workgroup."""

    wg: int
    start: int  # inclusive, in flattened iteration space
    end: int  # exclusive

    @property
    def size(self) -> int:
        """Number of MAC iterations in this range."""
        return self.end - self.start


@dataclass(frozen=True)
class TileContribution:
    """Which workgroups contribute to one output tile in the SK region.

    ``first_wg..last_wg`` is always contiguous because workgroup iteration
    ranges are contiguous and sorted — the property the fix-up kernel relies
    on to reduce partials with a static gather.
    """

    tile: int
    first_wg: int
    last_wg: int  # inclusive

    @property
    def num_contributors(self) -> int:
        """How many workgroups write partials for this tile."""
        return self.last_wg - self.first_wg + 1

    @property
    def is_split(self) -> bool:
        """True when the tile needs a fix-up reduction (>1 contributor)."""
        return self.num_contributors > 1


@dataclass(frozen=True)
class Partition:
    """Complete static schedule for one (shape, tile config, g, policy)."""

    shape: GemmShape
    cfg: TileConfig
    g: int
    policy: Policy
    m_tiles: int
    n_tiles: int
    iters_per_tile: int
    sk_tiles: int  # tiles [0, sk_tiles) are Stream-K; rest data-parallel
    sk_ranges: Tuple[WorkRange, ...]
    contributions: Tuple[TileContribution, ...]  # one per SK tile

    @property
    def n_tiles_total(self) -> int:
        """Total output tiles (SK region + data-parallel region)."""
        return self.m_tiles * self.n_tiles

    @property
    def dp_tiles(self) -> int:
        """Output tiles scheduled conventionally (one workgroup each)."""
        return self.n_tiles_total - self.sk_tiles

    @property
    def dp_waves(self) -> int:
        """Full ``g``-wide waves needed for the data-parallel region."""
        return cdiv(self.dp_tiles, self.g)

    @property
    def sk_total_iters(self) -> int:
        """Flattened MAC iterations in the Stream-K region."""
        return self.sk_tiles * self.iters_per_tile

    @cached_property
    def n_split_tiles(self) -> int:
        """SK tiles with >1 contributor — the fix-up kernel's workload."""
        return sum(1 for c in self.contributions if c.is_split)

    @cached_property
    def max_contributors(self) -> int:
        """Worst-case contributors to any tile (partials workspace depth);
        cached, since every kernel launch of the port reads it on the host."""
        return max((c.num_contributors for c in self.contributions), default=1)

    def tile_mn(self, tile: int) -> Tuple[int, int]:
        """Output-tile coordinates for a flattened tile index (row-major)."""
        return tile // self.n_tiles, tile % self.n_tiles


def sk_tile_count(n_tiles_total: int, g: int, policy: Policy) -> int:
    """How many output tiles the Stream-K region covers under a policy.

    HYBRID(1) covers exactly the quantized remainder wave ("data-parallel
    followed by one-batch Stream-K" in the original paper, except Stream-K++
    schedules the SK region FIRST). HYBRID(b) additionally converts ``b-1``
    full waves. When the tile count divides the grid evenly there is no
    remainder pathology, so HYBRID(b) converts ``b-1`` full waves only.
    """
    if policy.kind == PolicyKind.DP:
        return 0
    if policy.kind == PolicyKind.ALL_SK:
        return n_tiles_total
    rem = n_tiles_total % g
    base = rem if rem else 0
    extra = (policy.sk_batches - 1) * g
    return min(n_tiles_total, base + extra)


def partition(
    shape: GemmShape, cfg: TileConfig, g: int, policy: Policy
) -> Partition:
    """Build the full static schedule (Algorithm 1 lines 2-13, both regions)."""
    if g < 1:
        raise ValueError("grid size must be >= 1")
    m_tiles = cdiv(shape.m, cfg.bm)
    n_tiles = cdiv(shape.n, cfg.bn)
    ipt = cdiv(shape.k, cfg.bk)
    n_total = m_tiles * n_tiles

    sk_tiles = sk_tile_count(n_total, g, policy)
    sk_total = sk_tiles * ipt

    # Algorithm 1 line 4: iters_per_wg = ceil(total_iters / g); workgroup x
    # owns [x*ipw, min((x+1)*ipw, total)). Workgroups past the end own nothing.
    ranges: List[WorkRange] = []
    if sk_total:
        ipw = cdiv(sk_total, g)
        for x in range(g):
            s = min(x * ipw, sk_total)
            e = min(s + ipw, sk_total)
            ranges.append(WorkRange(x, s, e))
    else:
        ranges = [WorkRange(x, 0, 0) for x in range(g)]

    # Static contribution table: tile t spans flattened iterations
    # [t*ipt, (t+1)*ipt); its contributors are the wgs whose range intersects.
    contribs: List[TileContribution] = []
    if sk_total:
        ipw = cdiv(sk_total, g)
        for t in range(sk_tiles):
            t0, t1 = t * ipt, (t + 1) * ipt
            first = t0 // ipw
            last = (t1 - 1) // ipw
            contribs.append(TileContribution(t, first, last))
    return Partition(
        shape=shape,
        cfg=cfg,
        g=g,
        policy=policy,
        m_tiles=m_tiles,
        n_tiles=n_tiles,
        iters_per_tile=ipt,
        sk_tiles=sk_tiles,
        sk_ranges=tuple(ranges),
        contributions=tuple(contribs),
    )


@dataclass(frozen=True)
class PartitionStats:
    """O(g) aggregate view of a partition — everything the cost model needs
    without materialising per-tile contribution lists (the full
    ``partition`` is O(tiles) and exists for the kernels; hypothesis tests
    assert these aggregates agree with it)."""

    m_tiles: int
    n_tiles: int
    iters_per_tile: int
    n_tiles_total: int
    sk_tiles: int
    sk_total_iters: int
    dp_tiles: int
    dp_waves: int
    n_split_tiles: int
    extra_contributors: int  # sum over tiles of (num_contributors - 1)


def partition_stats(
    shape: GemmShape, cfg: TileConfig, g: int, policy: Policy
) -> PartitionStats:
    """O(g) aggregates for one (shape, cfg, g, policy) schedule.

    A :class:`GroupedGemmShape` with ``groups > 1`` models the fused
    single-kernel grouped form: the tile space is the *concatenation* of
    every group's tiles (``groups * m_tiles * n_tiles``), owned by one
    persistent grid. Under any Stream-K policy the whole concatenated space
    runs work-centric (HYBRID degenerates to ALL_SK — the single fused
    launch has no separate data-parallel region to hand tiles to), and the
    sequential-carry kernel resolves ragged tile boundaries in VMEM, so
    there is no partials round-trip: ``n_split_tiles`` and
    ``extra_contributors`` are 0 by construction. What Stream-K buys here
    is iteration-level (instead of tile-level) wave quantization over the
    concatenated space — exactly the paper's core claim, applied across
    expert boundaries."""
    groups = getattr(shape, "groups", 1)
    m_tiles = cdiv(shape.m, cfg.bm)
    n_tiles = cdiv(shape.n, cfg.bn)
    ipt = cdiv(shape.k, cfg.bk)
    if groups > 1:
        n_total = groups * m_tiles * n_tiles
        sk_tiles = 0 if policy.kind == PolicyKind.DP else n_total
        return PartitionStats(
            m_tiles=m_tiles,
            n_tiles=n_tiles,
            iters_per_tile=ipt,
            n_tiles_total=n_total,
            sk_tiles=sk_tiles,
            sk_total_iters=sk_tiles * ipt,
            dp_tiles=n_total - sk_tiles,
            dp_waves=cdiv(n_total - sk_tiles, g),
            n_split_tiles=0,
            extra_contributors=0,
        )
    n_total = m_tiles * n_tiles
    sk_tiles = sk_tile_count(n_total, g, policy)
    sk_total = sk_tiles * ipt
    dp_tiles = n_total - sk_tiles
    dp_waves = cdiv(dp_tiles, g)

    n_split = extra = 0
    if sk_total:
        ipw = cdiv(sk_total, g)
        n_ranges = cdiv(sk_total, ipw)
        split_tiles = set()
        for j in range(1, n_ranges):
            b = j * ipw  # interior boundary between wg j-1 and j
            if b % ipt:
                split_tiles.add(b // ipt)
                extra += 1
        n_split = len(split_tiles)
    return PartitionStats(
        m_tiles=m_tiles,
        n_tiles=n_tiles,
        iters_per_tile=ipt,
        n_tiles_total=n_total,
        sk_tiles=sk_tiles,
        sk_total_iters=sk_total,
        dp_tiles=dp_tiles,
        dp_waves=dp_waves,
        n_split_tiles=n_split,
        extra_contributors=extra,
    )
