"""Calibration: fit the analytical cost model against journaled wall clocks
(the port's copy of ``repro.core.calibrate``).

The cost model (:mod:`repro_torch.core.costmodel`) ships with nominal
constants (TPU-v5e, and the H100's data-sheet rates). Real machines differ —
and the tuning journal already holds ``(fingerprint, policy, cfg, g) ->
wall`` measurements (every :class:`~repro_torch.core.tuner.TuningRecord`
stores the winner's measured TFLOP/s, from which the wall clock is
``flops / (tflops * 1e12)``; on the card ``measure_wallclock`` times the
hand-written kernels). This module closes the loop: decompose each record's
modeled time into the four machine terms —

  * lane FLOP/s            (``Machine.peak_flops``),
  * lane HBM bandwidth     (``Machine.hbm_bw``),
  * launch overhead        (``Machine.launch_overhead_s``),
  * fix-up serialization   (``Machine.fixup_serial_s``),

— and solve the robust weighted least-squares problem ``wall_i ≈ C_i · θ``
per *dtype profile* (a mixed ``f32*int8`` op moves different bytes than an
f32 one, so its bandwidth term calibrates separately). The model's
``max(compute, memory)`` per-iteration roofline and the HYBRID
fix-up/DP-overlap ``max`` are handled by active-set iteration: branches are
chosen under the current estimate, the resulting *linear* system is solved
(inverse-parameterised, Huber-weighted on relative residuals), and the loop
repeats until the branch set stabilises.

The result is a :class:`CalibratedMachine`: one fitted
:class:`~repro_torch.core.costmodel.Machine` per dtype profile plus a base
fallback. It is hashable/frozen — scoring caches key on the Machine
instance, so installing a calibration can never read stale default-``V5E``
scores — and it persists as its own journal entry type
(:func:`calibration_entry` / ``TuningDatabase.replay_journal``), merged
across a fleet (:mod:`repro_torch.core.federate`) under the same hybrid
``(wall, version)`` last-writer-wins stamps as tuning records.

Fitting refuses to run under :data:`MIN_RECORDS` usable records — a fit on
a handful of points would happily produce garbage coefficients that then
steer every model-first dispatch.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import costmodel
from repro_torch.core.costmodel import DtypeBytes, Machine, V5E
from repro_torch.core.policies import TileConfig, policy_from_name
from repro_torch.core.tuner import TuningRecord, _key_shape
from repro_torch.core.workpart import GemmShape, cdiv, partition_stats
from repro_torch.utils.logging import get_logger

log = get_logger("calibrate")

#: minimum usable records per dtype profile before a fit is attempted —
#: below this the solver is refused outright (CalibrationError), because a
#: sparse fit produces confident nonsense that model-first dispatch would
#: then launch.
MIN_RECORDS = 16

#: Huber threshold on *relative* residuals: records within 10% of the model
#: get full weight, outliers are down-weighted proportionally.
_HUBER_DELTA = 0.1

_CFG_CACHE: Dict[str, TileConfig] = {}


class CalibrationError(ValueError):
    """Raised when a fit is refused (too few records, no usable walls)."""


def profile_key(dt: DtypeBytes) -> str:
    """Canonical string key of a byte-width profile (``"a:b:out:acc"``)."""
    return f"{dt.a}:{dt.b}:{dt.out}:{dt.acc}"


def key_dtypes(key) -> DtypeBytes:
    """Byte-width profile a database key measured under: bare (M, N, K)
    keys tuned at the f32 profile (the tuner's ``_BARE_KEY_DTYPES``
    contract), extended keys carry their dtypes in positions 4/5."""
    if len(key) == 3:
        return costmodel.profile_for("float32", "float32")
    return costmodel.profile_for(key[4], key[5])


def record_wall_s(key, rec: TuningRecord) -> Optional[float]:
    """Measured wall clock one record encodes (``flops / tflops``), or
    ``None`` when the record carries no usable measurement."""
    if rec.tflops <= 0:
        return None
    shape = _key_shape(key, key)
    return shape.flops / (rec.tflops * 1e12)


def _cfg(name: str) -> TileConfig:
    cfg = _CFG_CACHE.get(name)
    if cfg is None:
        bm, bn, bk = (int(x) for x in name.split("x"))
        cfg = _CFG_CACHE.setdefault(name, TileConfig(bm, bn, bk))
    return cfg


# ---------------------------------------------------------------------------
# CalibratedMachine
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CalibratedMachine:
    """Per-dtype-profile fitted machines + the base fallback.

    Frozen and hashable: resolving ``machine_for(dt)`` yields a plain
    (frozen) :class:`Machine` that participates in every scoring-cache key,
    so two calibrations can never alias each other's memoised scores.
    ``(wall, version)`` is the hybrid federation stamp — identical
    semantics to :class:`~repro_torch.core.tuner.TuningRecord`'s."""

    base: Machine = V5E
    #: sorted (profile_key, fitted Machine) pairs
    profiles: Tuple[Tuple[str, Machine], ...] = ()
    n_records: int = 0  # journal records the fit consumed
    residual: float = 0.0  # median |relative residual| across fitted profiles
    wall: float = 0.0  # hybrid LWW stamp (see TuningRecord.wall)
    version: int = 0
    #: arch class the walls behind this fit were measured on (see
    #: :mod:`repro_torch.core.arch`): ``TuningDatabase.set_calibration`` installs
    #: same-class fits locally and routes foreign-class ones to the
    #: per-class side table — a sibling generation's constants must never
    #: steer local model-first dispatch. Legacy fits parse as "default".
    arch: str = "default"

    def machine_for(self, dt: DtypeBytes) -> Machine:
        """Fitted machine for a byte-width profile (base when unfitted)."""
        key = profile_key(dt)
        for k, m in self.profiles:
            if k == key:
                return m
        return self.base

    @property
    def fitted_profiles(self) -> Tuple[str, ...]:
        """Profile keys that actually fitted (vs. falling back to base)."""
        return tuple(k for k, _ in self.profiles)


# ---------------------------------------------------------------------------
# feature decomposition (mirrors costmodel.gemm_time_s term by term)
# ---------------------------------------------------------------------------


def _features(
    shape: GemmShape,
    cfg: TileConfig,
    policy,
    g: int,
    dt: DtypeBytes,
    mach: Machine,
) -> np.ndarray:
    """One record's design row ``[c_invpeak, c_invbw, c_launch, c_fixup]``
    such that modeled time = row · (1/peak_flops, 1/hbm_bw, launch, fixup).

    The two ``max`` nonlinearities in the model (per-iteration roofline,
    HYBRID fix-up/DP overlap) are resolved under ``mach`` — the caller's
    current estimate — making the system linear for one active-set step."""
    st = partition_stats(shape, cfg, g, policy)
    mult = cdiv(g, mach.lanes)
    iter_flops = 2 * cfg.bm * cfg.bn * cfg.bk
    iter_bytes = cfg.bm * cfg.bk * dt.a + cfg.bk * cfg.bn * dt.b
    # one lane's iteration cost = max(iter_flops*lanes/peak, iter_bytes*lanes/bw)
    compute_bound = (
        iter_flops * mach.lanes / mach.peak_flops
        >= iter_bytes * mach.lanes / mach.hbm_bw
    )
    per_iter = np.zeros(4)
    if compute_bound:
        per_iter[0] = iter_flops * mach.lanes
    else:
        per_iter[1] = iter_bytes * mach.lanes

    row = np.zeros(4)
    row[2] = 1.0  # launch overhead
    row[1] += st.n_tiles_total * cfg.bm * cfg.bn * dt.out  # output writeback

    fix = np.zeros(4)
    fix[1] = st.extra_contributors * cfg.bm * cfg.bn * dt.acc * 2
    fix[3] = st.n_split_tiles

    if st.sk_tiles:
        row += cdiv(st.sk_total_iters, g) * mult * per_iter
        dp_units = st.dp_waves * mult * st.iters_per_tile
        if st.dp_tiles:
            # overlap: the slower of (DP phase, fix-up) under current mach
            t_iter = max(
                iter_flops / mach.lane_flops, iter_bytes / mach.lane_bw
            )
            dp_t = dp_units * t_iter
            fix_t = fix[1] / mach.hbm_bw + fix[3] * mach.fixup_serial_s
            row += dp_units * per_iter if dp_t >= fix_t else fix
        else:
            row += fix
    else:
        row += st.dp_waves * mult * st.iters_per_tile * per_iter
    return row


def _theta(mach: Machine) -> np.ndarray:
    return np.array(
        [
            1.0 / mach.peak_flops,
            1.0 / mach.hbm_bw,
            mach.launch_overhead_s,
            mach.fixup_serial_s,
        ]
    )


def _machine(theta: np.ndarray, base: Machine) -> Machine:
    return dataclasses.replace(
        base,
        peak_flops=float(1.0 / theta[0]),
        hbm_bw=float(1.0 / theta[1]),
        launch_overhead_s=float(max(theta[2], 0.0)),
        fixup_serial_s=float(max(theta[3], 0.0)),
    )


def fit_profile(
    samples: Sequence[Tuple[GemmShape, TileConfig, object, int]],
    walls: Sequence[float],
    dt: DtypeBytes,
    base: Machine = V5E,
    max_iters: int = 12,
    min_records: int = MIN_RECORDS,
) -> Tuple[Machine, float]:
    """Fit one dtype profile's machine terms against measured walls.

    Active-set IRLS: resolve the model's ``max`` branches under the current
    estimate, solve the weighted linear system (weights ``1/wall²`` so
    microsecond decode GEMMs count as much as millisecond trainers, times a
    Huber factor on relative residuals), repeat until the estimate is
    stable. Terms the data cannot identify (e.g. ``fixup_serial_s`` when no
    record has split tiles) are pinned to ``base``'s values. Returns the
    fitted machine and the median |relative residual|."""
    if len(samples) < min_records:
        raise CalibrationError(
            f"refusing to fit on {len(samples)} records (< {min_records})"
        )
    y = np.asarray(walls, dtype=np.float64)
    theta = _theta(base)
    rel = np.zeros(len(y))
    for _ in range(max_iters):
        mach = _machine(theta, base)
        C = np.stack(
            [_features(s, cfg, pol, g, dt, mach) for s, cfg, pol, g in samples]
        )
        w = 1.0 / np.maximum(y, 1e-12)
        huber = np.where(
            np.abs(rel) <= _HUBER_DELTA,
            1.0,
            _HUBER_DELTA / np.maximum(np.abs(rel), 1e-12),
        )
        w = w * np.sqrt(huber)
        # identifiability: pin columns the data never excites to base
        col_scale = np.abs(C * w[:, None]).sum(axis=0)
        active = col_scale > 1e-9 * max(col_scale.max(), 1e-300)
        y_eff = y - C[:, ~active] @ theta[~active]
        sol, *_ = np.linalg.lstsq(
            C[:, active] * w[:, None], y_eff * w, rcond=None
        )
        new = theta.copy()
        new[active] = sol
        # positivity: rate terms must stay invertible, additive terms >= 0
        new[0] = max(new[0], 1e-18)
        new[1] = max(new[1], 1e-15)
        new[2] = max(new[2], 0.0)
        new[3] = max(new[3], 0.0)
        pred = C @ new
        rel = (pred - y) / np.maximum(y, 1e-12)
        if np.all(np.abs(new - theta) <= 1e-9 * np.maximum(np.abs(theta), 1e-30)):
            theta = new
            break
        theta = new
    return _machine(theta, base), float(np.median(np.abs(rel)))


def calibrate_records(
    records: Iterable[Tuple[object, TuningRecord]],
    base: Machine = V5E,
    min_records: int = MIN_RECORDS,
    arch: str = "default",
) -> CalibratedMachine:
    """Fit a :class:`CalibratedMachine` from ``(key, record)`` pairs.

    Records group by dtype profile; each group with at least
    ``min_records`` usable walls fits its own machine, smaller groups fall
    back to ``base`` at resolve time. Raises :class:`CalibrationError` when
    *no* profile reaches the floor — the caller must not install an
    unfitted calibration believing it learned something."""
    groups: Dict[str, List] = {}
    walls: Dict[str, List[float]] = {}
    n_used = 0
    for key, rec in records:
        wall = record_wall_s(key, rec)
        if wall is None:
            continue
        try:
            shape = _key_shape(key, key)
            cfg = _cfg(rec.cfg)
            pol = policy_from_name(rec.policy)
        except (ValueError, TypeError):
            continue
        dt = key_dtypes(key)
        pk = profile_key(dt)
        groups.setdefault(pk, []).append((shape, cfg, pol, rec.g))
        walls.setdefault(pk, []).append(wall)
        n_used += 1
    profiles: List[Tuple[str, Machine]] = []
    residuals: List[float] = []
    for pk in sorted(groups):
        if len(groups[pk]) < min_records:
            log.info(
                "profile %s: %d records < %d floor, falling back to base",
                pk,
                len(groups[pk]),
                min_records,
            )
            continue
        dt = DtypeBytes(*(int(x) for x in pk.split(":")))
        mach, resid = fit_profile(
            groups[pk], walls[pk], dt, base=base, min_records=min_records
        )
        profiles.append((pk, mach))
        residuals.append(resid)
        log.info(
            "profile %s: fitted on %d records (peak %.1f TF/s, bw %.0f GB/s, "
            "launch %.2fus, fixup %.2fus, median |rel resid| %.3f)",
            pk,
            len(groups[pk]),
            mach.peak_flops / 1e12,
            mach.hbm_bw / 1e9,
            mach.launch_overhead_s * 1e6,
            mach.fixup_serial_s * 1e6,
            resid,
        )
    if not profiles:
        raise CalibrationError(
            f"no dtype profile reached {min_records} usable records "
            f"({n_used} total across {len(groups)} profiles)"
        )
    return CalibratedMachine(
        base=base,
        profiles=tuple(profiles),
        n_records=n_used,
        residual=float(np.median(residuals)),
        arch=arch,
    )


def calibrate_db(
    db, base: Machine = V5E, min_records: int = MIN_RECORDS
) -> CalibratedMachine:
    """Fit from a :class:`~repro_torch.core.tuner.TuningDatabase`'s OWN-class
    records (foreign-class ``xarch`` records measured other hardware —
    folding their walls in would corrupt the local constants); the fit is
    stamped with the database's arch class."""
    return calibrate_records(
        db.records.items(), base=base, min_records=min_records, arch=db.arch
    )


def calibrate_journal(
    path: str,
    base: Machine = V5E,
    min_records: int = MIN_RECORDS,
    arch: str = "default",
) -> CalibratedMachine:
    """Fit from an append-only tuning journal (replayed, later lines win).
    ``arch`` is the local class: only same-class journal records feed the
    fit (they land in ``records``; foreign lines route to ``xarch``)."""
    from repro_torch.core.tuner import TuningDatabase

    db = TuningDatabase(arch=arch)
    db.replay_journal(path)
    return calibrate_db(db, base=base, min_records=min_records)


# ---------------------------------------------------------------------------
# persistence: the calibration journal entry type
# ---------------------------------------------------------------------------


def machine_to_json(mach: Machine) -> dict:
    """JSON form of a Machine (plain field dict)."""
    return dataclasses.asdict(mach)


def machine_from_json(d: dict, base: Machine = V5E) -> Machine:
    """Inverse of :func:`machine_to_json`; unknown fields are rejected so a
    format skew fails loudly, missing fields inherit ``base``."""
    names = {f.name for f in dataclasses.fields(Machine)}
    extra = set(d) - names
    if extra:
        raise ValueError(f"unknown Machine fields {sorted(extra)}")
    return dataclasses.replace(base, **d)


def calibration_to_json(cm: CalibratedMachine) -> dict:
    """JSON payload of a calibration (the journal entry body).
    Default-class fits serialize without the ``arch`` field, byte-identical
    to the pre-arch format."""
    out = {
        "base": machine_to_json(cm.base),
        "profiles": {k: machine_to_json(m) for k, m in cm.profiles},
        "n_records": cm.n_records,
        "residual": cm.residual,
        "wall": cm.wall,
        "version": cm.version,
    }
    if cm.arch != "default":
        out["arch"] = cm.arch
    return out


def calibration_from_json(d: dict) -> CalibratedMachine:
    """Inverse of :func:`calibration_to_json` (arch-less legacy payloads
    parse into the ``"default"`` class)."""
    base = machine_from_json(d["base"])
    return CalibratedMachine(
        base=base,
        profiles=tuple(
            (k, machine_from_json(m, base=base))
            for k, m in sorted(d.get("profiles", {}).items())
        ),
        n_records=int(d.get("n_records", 0)),
        residual=float(d.get("residual", 0.0)),
        wall=float(d.get("wall", 0.0)),
        version=int(d.get("version", 0)),
        arch=str(d.get("arch", "default")),
    )


def better_calibration(
    a: Optional[CalibratedMachine], b: Optional[CalibratedMachine]
) -> Optional[CalibratedMachine]:
    """Deterministic last-writer-wins winner between two calibrations.

    Orders on the hybrid ``(wall, version)`` stamp first — the same order
    tuning records federate under — then ``n_records`` (more data wins a
    stamp tie), then the serialized payload as the final
    arbitrary-but-stable arbiter, so merges commute whatever order shards
    arrive in. ``None`` loses to anything."""
    if a is None:
        return b
    if b is None:
        return a

    def _key(cm: CalibratedMachine):
        return (
            cm.wall,
            cm.version,
            cm.n_records,
            json.dumps(calibration_to_json(cm), sort_keys=True),
        )

    return a if _key(a) >= _key(b) else b


def calibration_entry(cm: CalibratedMachine) -> str:
    """One journal line carrying a calibration — the second entry type the
    tuning journal understands (``TuningDatabase.replay_journal`` applies
    it under last-writer-wins against any calibration already installed)."""
    return json.dumps({"calibration": calibration_to_json(cm)})


def append_calibration(path: str, cm: CalibratedMachine) -> None:
    """Append a calibration entry to the JSONL journal."""
    with open(path, "a") as f:
        f.write(calibration_entry(cm) + "\n")
