"""Analytical GEMM cost model (the port's copy of ``repro.core.costmodel``,
plus the nominal :data:`H100` machine beside :data:`V5E`).

The paper tunes by wall-clocking kernels on an MI250X. This container has no
accelerator, so the ckProfiler-analogue tuner measures against this
calibrated analytical model instead; on real hardware the measurement
function is swapped for wall-clock timing (``tuner.measure_wallclock``) with
zero changes elsewhere — the model IS the hardware-adaptation layer.

Machine model (TPU v5e):
  * ``peak_flops``  — 197 TFLOP/s bf16 per chip (MXU).
  * ``hbm_bw``      — 819 GB/s.
  * ``lanes`` (C)   — number of concurrent tile slots; the TPU analogue of
    the paper's "CU count" (GPU: 104 CUs). A v5e TensorCore has 4 MXUs x 2
    pipeline slots -> C = 8 by default. Output-tile schedules quantize into
    ``ceil(T / C)`` waves exactly like GPU wavefront rounds — this is the
    pathology Stream-K removes.
  * MXU tiles are *padded*: a (BM, BN, BK) tile costs the full
    2*BM*BN*BK FLOPs even when M < BM (systolic array shape is fixed) — this
    is why tile-config selection matters for skinny GEMMs and why the tuner
    sweeps configs jointly with policies.

Grid size ``g`` (number of persistent workgroups the flattened iteration
space is split over) is a *tuning axis*, not a hardware constant: the
original Stream-K paper shows performance is highly sensitive to it. The
model keeps ``g`` distinct from ``lanes``: ``g`` workgroups time-share the
``lanes`` physical slots, so every wave of ``g`` programs costs
``ceil(g / lanes)`` lane-rounds. ``g == lanes`` reproduces the legacy
one-program-per-lane schedule exactly; ``g != lanes`` changes the HYBRID
remainder wave (``T mod g``), the split-tile fix-up plan, and DP wave
quantization — which is why the tuner sweeps it jointly with (policy, tile).

Dtype awareness: every timing term is keyed on the *actual* operand
byte-widths (:class:`DtypeBytes`) — A/B input widths drive the HBM term of
each k-iteration, the output width drives the C writeback, and the f32
accumulator width drives fix-up traffic and VMEM feasibility. f32, bf16 and
int8 ops of the same MNK therefore score (and can select) differently. The
module-level default stays the paper's fp16-suite 2-byte profile so bare
(M, N, K) scoring is unchanged.

Timing terms:
  t_tile  = max(tile_flops / lane_flops, tile_bytes / lane_bw)
  DP      : ceil(T/g) * mult * t_tile                            (wave rounds)
  ALL_SK  : ceil(total_iters/g) * mult * t_iter + fixup          (Algorithm 1)
  HYBRID_b: sk_body + max(dp_waves * mult * t_tile, fixup)       (overlap §4.1)
  mult    = ceil(g / lanes)                       (lane multiplexing rounds)

Fix-up (TPU two-phase reduction replacing GPU atomics): every split tile's
non-owning contributors round-trip a BM*BN f32 partial through HBM, plus a
per-split-tile serialization latency (the analogue of the paper's
"thousands of clock cycles" atomic-add tail).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Tuple

from repro_torch.core.policies import (
    ALL_POLICIES,
    DEFAULT_TILE_CONFIGS,
    DP,
    Policy,
    TileConfig,
)
from repro_torch.core.workpart import (
    GemmShape,
    GroupedGemmShape,
    PartitionStats,
    cdiv,
    partition_stats,
)


@dataclass(frozen=True)
class Machine:
    """Hardware constants; defaults are TPU v5e."""

    peak_flops: float = 197e12  # bf16 FLOP/s per chip (MXU)
    hbm_bw: float = 819e9  # B/s
    lanes: int = 8  # concurrent tile slots (virtual CUs)
    ici_bw: float = 50e9  # B/s per link (used by the roofline module)
    launch_overhead_s: float = 2e-6  # kernel launch + grid setup
    fixup_serial_s: float = 1.2e-6  # per-split-tile reduction tail
    vmem_bytes: int = 16 * 2 ** 20  # ~16 MiB usable VMEM per lane's working set

    @property
    def lane_flops(self) -> float:
        """Peak FLOP/s available to one lane (virtual CU)."""
        return self.peak_flops / self.lanes

    @property
    def lane_bw(self) -> float:
        """HBM bandwidth share of one lane (B/s)."""
        return self.hbm_bw / self.lanes


V5E = Machine()

#: NVIDIA H100 SXM at its NOMINAL data-sheet constants (none measured here):
#: 989 TFLOP/s dense bf16 tensor-core peak, 3.35 TB/s HBM3, one lane per SM
#: (132), NVLink 450 GB/s each way, and the shared memory one block may use
#: (232,448 bytes) as the tile working-set budget in place of VMEM. The
#: launch and fix-up latency terms keep the V5E defaults until a calibration
#: refits them from measured wall clocks.
H100 = Machine(
    peak_flops=989e12,
    hbm_bw=3.35e12,
    lanes=132,
    ici_bw=450e9,
    vmem_bytes=232448,
)


def default_grid_sizes(mach: Machine = V5E) -> Tuple[int, ...]:
    """The swept grid sizes: {lanes/2, lanes, 2*lanes}, deduped, ascending —
    the "additional tuning parameter" axis the tuner/selector sweep jointly
    with (policy, tile)."""
    lanes = mach.lanes
    return tuple(sorted({max(1, lanes // 2), lanes, 2 * lanes}))


# ---------------------------------------------------------------------------
# Dtype byte-width profiles
# ---------------------------------------------------------------------------

_WIDTHS = {
    "float64": 8,
    "float32": 4,
    "float16": 2,
    "bfloat16": 2,
    "int32": 4,
    "uint32": 4,
    "int16": 2,
    "uint16": 2,
    "int8": 1,
    "uint8": 1,
    # packed sub-byte dtypes: two nibbles per byte along K, so each element
    # moves half a byte through HBM (fractional widths are what the tile-time
    # bytes terms multiply by — they never index an array dtype directly)
    "int4": 0.5,
    "uint4": 0.5,
}


def dtype_width(name: str) -> float:
    """Byte width of a dtype fingerprint component (e.g. ``"bfloat16"``).
    Sub-byte packed dtypes are fractional (``int4`` -> 0.5). Unknown names
    fall back to the bit-count embedded in the name (so ``float8_e4m3fn``
    -> 1) and finally to 4 bytes."""
    w = _WIDTHS.get(name)
    if w is not None:
        return w
    m = re.search(r"(\d+)", name)
    if m:
        return max(1, int(m.group(1)) // 8)
    return 4


@dataclass(frozen=True)
class DtypeBytes:
    """Operand byte-widths one GEMM dispatch actually moves.

    ``a``/``b`` are the input widths (distinct, so mixed bf16-activation x
    int8-weight ops model their real A/B traffic; fractional for packed
    sub-byte weights — int4 B moves 0.5 bytes/element), ``out`` the C
    width, and ``acc`` the accumulator width (f32 partials in every kernel
    here — fix-up traffic and VMEM accumulators are ``acc``-wide regardless
    of the input dtype)."""

    a: float = 2
    b: float = 2
    out: float = 2
    acc: float = 4


#: module default: the paper's fp16 benchmark suite moves 2-byte operands;
#: bare (M, N, K) scoring keeps this profile so legacy artifacts are stable.
DEFAULT_DTYPES = DtypeBytes()


#: floor for the inferred C width when the op fingerprint has no out_dtype:
#: no kernel here stores integer-width outputs — the epilogue rescales the
#: f32 accumulator and casts to a float dtype at least 2 bytes wide, so an
#: int8*int8 op must not score a 1-byte C write.
_MIN_STORE_WIDTH = 2


def profile_for(in_dtype: str, out_dtype: Optional[str] = None) -> DtypeBytes:
    """DtypeBytes for a :class:`~repro.core.op.GemmOp`'s dtype fingerprints.
    ``in_dtype`` may be the mixed ``"<a_dtype>*<b_dtype>"`` form. When the
    op carries no out_dtype the C width is inferred from the inputs but
    clamped to :data:`_MIN_STORE_WIDTH` — low-precision inputs shrink A/B
    traffic, never the stored output."""
    if "*" in in_dtype:
        a_name, b_name = in_dtype.split("*", 1)
    else:
        a_name = b_name = in_dtype
    a = dtype_width(a_name)
    b = dtype_width(b_name)
    out = dtype_width(out_dtype) if out_dtype else max(a, b, _MIN_STORE_WIDTH)
    return DtypeBytes(a=a, b=b, out=out)


def op_dtypes(op) -> DtypeBytes:
    """Profile for a GemmOp (duck-typed: anything with in_dtype/out_dtype)."""
    return profile_for(op.in_dtype, op.out_dtype)


def op_shape(op) -> GemmShape:
    """Shape the cost model should score for an op fingerprint.

    A fused grouped op scores as a :class:`GroupedGemmShape` over the
    concatenated tile space of its local group count — one launch, one
    persistent grid, G-independent trace cost. Everything else (plain ops,
    loop-form grouped/batched ops, whose backend launches per group and
    whose selection covers one group's local problem) scores the plain
    per-group shape, exactly as before."""
    m, n, k = op.local
    if getattr(op, "fused", False):
        return GroupedGemmShape(m, n, k, groups=op.g_local)
    return GemmShape(m, n, k)


# ---------------------------------------------------------------------------
# Timing terms
# ---------------------------------------------------------------------------


def _tile_times(mach: Machine, cfg: TileConfig, dt: DtypeBytes = DEFAULT_DTYPES):
    """t_single_k_iter for one lane."""
    # One k-iteration moves an A (BM,BK) and B (BK,BN) tile HBM->VMEM and
    # issues 2*BM*BN*BK MACs on the MXU; A and B widths differ for mixed
    # activation x weight dtypes.
    iter_flops = 2 * cfg.bm * cfg.bn * cfg.bk
    iter_bytes = cfg.bm * cfg.bk * dt.a + cfg.bk * cfg.bn * dt.b
    t_iter = max(iter_flops / mach.lane_flops, iter_bytes / mach.lane_bw)
    return t_iter


def _fixup_time(
    mach: Machine, st: PartitionStats, cfg: TileConfig, dt: DtypeBytes = DEFAULT_DTYPES
) -> float:
    """Two-phase reduction cost: partial write + read + final write, plus a
    serialization tail per split tile. Partials are accumulator-width."""
    acc_bytes = cfg.bm * cfg.bn * dt.acc
    bytes_moved = st.extra_contributors * acc_bytes * 2  # write + read back
    return bytes_moved / mach.hbm_bw + st.n_split_tiles * mach.fixup_serial_s


def _output_time(
    mach: Machine, st: PartitionStats, cfg: TileConfig, dt: DtypeBytes = DEFAULT_DTYPES
) -> float:
    return (st.n_tiles_total * cfg.bm * cfg.bn * dt.out) / mach.hbm_bw


def vmem_working_set(cfg: TileConfig, dt: DtypeBytes = DEFAULT_DTYPES) -> int:
    """Dtype-aware VMEM claim: ``TileConfig.vmem_bytes`` at the profile's
    real A/B/accumulator widths (one source of truth for the formula)."""
    return cfg.vmem_bytes(
        in_dtype_bytes=dt.a, acc_dtype_bytes=dt.acc, b_dtype_bytes=dt.b
    )


@lru_cache(maxsize=200_000)
def gemm_time_s(
    shape: GemmShape,
    cfg: TileConfig,
    policy: Policy,
    mach: Machine = V5E,
    g: Optional[int] = None,
    dt: DtypeBytes = DEFAULT_DTYPES,
) -> float:
    """Modeled execution time of one GEMM under (cfg, policy, g, dtypes)."""
    g = g or mach.lanes
    st = partition_stats(shape, cfg, g, policy)
    t_iter = _tile_times(mach, cfg, dt)
    t_tile = st.iters_per_tile * t_iter
    # g workgroups time-share `lanes` physical slots: each wave of g programs
    # costs ceil(g/lanes) lane-rounds (mult == 1 for the legacy g == lanes).
    mult = cdiv(g, mach.lanes)

    t = mach.launch_overhead_s + _output_time(mach, st, cfg, dt)
    if st.sk_tiles:
        sk_body = cdiv(st.sk_total_iters, g) * mult * t_iter
        fixup = _fixup_time(mach, st, cfg, dt)
        dp = st.dp_waves * mult * t_tile
        if st.dp_tiles:
            # SK scheduled first; fix-up latency hidden under the DP phase
            # (§4.1 "strategic overlap of execution").
            t += sk_body + max(dp, fixup)
        else:
            t += sk_body + fixup
    else:
        t += st.dp_waves * mult * t_tile
    return t


def gemm_tflops(
    shape: GemmShape,
    cfg: TileConfig,
    policy: Policy,
    mach: Machine = V5E,
    g: Optional[int] = None,
    dt: DtypeBytes = DEFAULT_DTYPES,
) -> float:
    """Modeled effective TFLOP/s (true FLOPs / modeled time) — the tuner's
    objective, matching ckProfiler's reporting."""
    return shape.flops / gemm_time_s(shape, cfg, policy, mach, g, dt) / 1e12


@lru_cache(maxsize=50_000)
def rank_candidates(
    shape: GemmShape,
    mach: Machine = V5E,
    policies: Tuple[Policy, ...] = ALL_POLICIES,
    tile_configs: Tuple[TileConfig, ...] = DEFAULT_TILE_CONFIGS,
    grid_sizes: Optional[Tuple[int, ...]] = None,
    dt: DtypeBytes = DEFAULT_DTYPES,
) -> Tuple[Tuple[Policy, TileConfig, int, float], ...]:
    """The full (policy, cfg, g) candidate list ordered by modeled time.

    This is THE ranking primitive of analytical-first selection: the tuner's
    budgeted top-k sweeps measure a prefix of it, the selector's ``"model"``
    dispatch source launches its head, and the regret benchmark compares its
    order against measured reality. Each entry is
    ``(policy, cfg, g, modeled_time_s)``, ascending (fastest first); VMEM
    feasibility is checked at the profile's real byte-widths. Exact modeled
    ties preserve the sweep's (policy, g, cfg) iteration order — the same
    deterministic order the legacy strict-argmax resolved them in, so
    refactoring to rank-then-take-head changes no winner.

    The cache keys on every argument *including the (frozen, hashable)
    ``Machine``* — swapping in a calibrated machine must never read scores
    memoised under the default ``V5E`` constants.
    """
    grids = grid_sizes if grid_sizes is not None else default_grid_sizes(mach)
    out = []
    for pol in policies:
        for g in grids:
            for cfg in tile_configs:
                if vmem_working_set(cfg, dt) > mach.vmem_bytes:
                    continue
                t = gemm_time_s(shape, cfg, pol, mach, g, dt)
                out.append((pol, cfg, g, t))
    if not out:
        raise AssertionError("no tile config fits VMEM")
    out.sort(key=lambda c: c[3])  # stable: ties keep iteration order
    return tuple(out)


def best_config(
    shape: GemmShape,
    policy: Policy,
    mach: Machine = V5E,
    tile_configs=DEFAULT_TILE_CONFIGS,
    g: Optional[int] = None,
    dt: DtypeBytes = DEFAULT_DTYPES,
) -> tuple[TileConfig, float]:
    """Best tile config for a fixed (policy, g): the argmin of
    :func:`rank_candidates` restricted to that policy and grid size. VMEM
    feasibility uses the op's real byte-widths: a config that fits bf16
    operands can overflow for f32."""
    ranked = rank_candidates(
        shape,
        mach,
        (policy,),
        tuple(tile_configs),
        (g or mach.lanes,),
        dt,
    )
    _, cfg, g_win, t = ranked[0]
    return cfg, shape.flops / t / 1e12


def dp_baseline_tflops(
    shape: GemmShape, mach: Machine = V5E, dt: DtypeBytes = DEFAULT_DTYPES
) -> float:
    """The paper's comparison baseline: best data-parallel configuration."""
    return best_config(shape, DP, mach, dt=dt)[1]
