"""ckProfiler analogue: exhaustive (policy x tile-config x grid-size) tuning
over a GEMM problem-size suite, producing the winner database that Open-sieve
encodes (the port's copy of ``repro.core.tuner``).

``measure_fn(shape, policy, cfg, g, dt) -> tflops`` is injected:
  * default: the analytical model (:func:`measure_model`; on the CPU its
    records equal the JAX package's);
  * :func:`measure_wallclock`: times the port's hand-written kernels on the
    CUDA device with CUDA events (the paper's 50 warm-up + 50 timed
    launches protocol). It has no CPU fallback.

The sweep covers the paper's (policy x tile) space jointly with the grid
size ``g`` the flattened iteration space is split over (``grid_sizes``,
default {lanes/2, lanes, 2*lanes}: 66, 132 and 264 under the nominal
:data:`~repro_torch.core.costmodel.H100`). Measurement is keyed on the
target's *actual* operand byte-widths: a :class:`~repro_torch.core.op.GemmOp`
target tunes under its own dtype profile, a bare (M, N, K) under the f32
profile (the bare key exact-matches f32 plain ops — see
``_BARE_KEY_DTYPES``), so f32/int8/bf16 ops of the same MNK can record
different winners.

Artifact lifecycle: ``TuningDatabase.save``/``load`` snapshot the full
database; incremental results — offline sweeps
(``python -m repro_torch.launch.tune``) and serve-time
:class:`repro_torch.core.adaptive.AdaptiveTuner` commits alike — stream
through an append-only JSONL *journal* that ``load``/``replay_journal``
re-applies on startup, so records learned while serving survive restarts
and warm-start the next run. ``version`` counts in-place appends, the
monotone clock the generational sieve rebuilds key on. Snapshots and
journal lines are byte-compatible with the JAX package's, both ways.

Backward compatibility: records/journal lines written before ``g`` became a
tuning axis carry no ``g`` field — they parse with ``g = LEGACY_GRID`` (8,
the grid every legacy kernel launch used), so old artifacts load and
dispatch identically. Likewise records written before federation carry no
``version``/``wall`` hybrid stamp — they parse with ``version = 0`` /
``wall = 0.0`` and lose last-writer-wins merges against any stamped record.

``Tuner.tune(shard=(i, n))`` tunes only the ``i``-th of ``n`` deterministic,
disjoint slices of the target list (strided, so the suite's size-correlated
cost balances across workers);
:func:`repro_torch.core.federate.merge_journal_shards` folds the shards'
journals back into the unsharded sweep's database.
"""

from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass, field, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import costmodel
from repro_torch.core.arch import DEFAULT_ARCH, ArchProfile
from repro_torch.core.costmodel import DtypeBytes
from repro_torch.core.op import (
    GROUPED_FUSED_MARKER,
    GemmOp,
    OpKey,
    key_from_str,
    key_to_str,
)
from repro_torch.core.opensieve import OpenSieve
from repro_torch.core.policies import (
    ALL_POLICIES,
    DEFAULT_TILE_CONFIGS,
    DP,
    Policy,
    TileConfig,
    policy_from_name,
)
from repro_torch.core.workpart import GemmShape, GroupedGemmShape
from repro_torch.utils.logging import get_logger

log = get_logger("tuner")

MNK = Tuple[int, int, int]
MeasureFn = Callable[[GemmShape, Policy, TileConfig, int, DtypeBytes], float]

#: grid size every record/journal line implied before ``g`` was swept —
#: the old kernels launched with g=8 unconditionally.
LEGACY_GRID = 8


def _as_key(entry) -> OpKey:
    """Normalise a tuning target to its database key: a GemmOp keys on its
    fingerprint, a bare 3-sequence on the legacy (M, N, K) tuple."""
    if isinstance(entry, GemmOp):
        return entry.key
    return tuple(entry)


def _key_local(key: OpKey) -> MNK:
    return (key[0], key[1], key[2])


def _key_shape(entry, key: OpKey) -> GemmShape:
    """Shape a tuning target sweeps. A GemmOp defers to
    :func:`costmodel.op_shape` (fused grouped ops measure their whole
    concatenated expert tile space); a raw 8-part ``grouped_fused`` key —
    e.g. replayed from a journal — reconstructs the same GroupedGemmShape;
    everything else sweeps the bare local (M, N, K) per group."""
    if isinstance(entry, GemmOp):
        return costmodel.op_shape(entry)
    if len(key) == 8 and key[7] == GROUPED_FUSED_MARKER:
        return GroupedGemmShape(key[0], key[1], key[2], groups=key[3])
    return GemmShape(*_key_local(key))


#: bare (M, N, K) targets tune under the float32 profile: a bare key is the
#: *exact-match* dispatch key of float32 plain ops (``GemmOp.is_plain``), so
#: the record must be honest for that owner — scoring it at 2-byte widths
#: would hand every f32 dispatch a bf16-optimal winner, the exact
#: mis-selection bug this module exists to avoid. bf16/f16 shape-only ops
#: consult bare records only as the paper's dtype-agnostic *fallback*
#: (selector ``_db_record``) until adaptation tunes their own fingerprint.
_BARE_KEY_DTYPES = costmodel.profile_for("float32", "float32")


def _target_dtypes(entry) -> DtypeBytes:
    """Byte-width profile a tuning target measures under: a GemmOp's real
    dtypes, or the f32 profile for bare (M, N, K) sizes (whose key
    exact-matches f32 plain ops)."""
    if isinstance(entry, GemmOp):
        return costmodel.op_dtypes(entry)
    return _BARE_KEY_DTYPES


@dataclass
class TuningRecord:
    """One tuned winner: the sweep result the database/journals persist."""

    size: OpKey  # legacy (M, N, K) or extended op-fingerprint key
    policy: str  # winner policy name
    cfg: str  # winner tile config name
    tflops: float
    runner_up_policy: str
    runner_up_tflops: float
    dp_best_tflops: float  # paper's baseline for tolerance analysis
    #: winner grid size; defaults to LEGACY_GRID so g-less records written
    #: before the grid sweep existed keep dispatching exactly as they did
    g: int = LEGACY_GRID
    #: producer commit clock: stamped by ``TuningDatabase.add_record`` (the
    #: database's monotone ``version`` at commit time) and carried through
    #: journals/snapshots, so federated merges can apply last-writer-wins
    #: per key. Pre-federation artifacts parse with 0 (always superseded).
    version: int = 0
    #: wall-clock half of the hybrid commit stamp (unix seconds, stamped by
    #: ``add_record`` alongside ``version``): per-producer version counters
    #: are not comparable across producers, so cross-producer
    #: last-writer-wins orders on ``(wall, version)`` — the wall clock
    #: makes it a true time order between producers, the producer clock
    #: breaks sub-resolution ties within one. Artifacts written before this
    #: field parse with 0.0 and lose to any wall-stamped record.
    wall: float = 0.0
    #: 1-based rank the cost model gave the measured winner at sweep time
    #: (1 = the model's own argmin won the measurement). The calibration
    #: drift signal: a healthy calibration keeps this small, a drifting one
    #: pushes winners deep into the ranking. ``-1`` on records written
    #: before top-k sweeps existed (or when the rank was not computed).
    model_rank: int = -1
    #: architecture class this record was measured on (see
    #: :mod:`repro_torch.core.arch`). Records federate last-writer-wins only
    #: *within* a class; a different class is never a direct database hit,
    #: only an ``"xarch"`` re-ranked warm seed. Arch-less legacy artifacts
    #: parse into ``"default"`` and dispatch exactly as before.
    arch: str = DEFAULT_ARCH

    @property
    def gain_over_runner_up(self) -> float:
        """Relative win over the next distinct policy (Fig. 3's quantity)."""
        if self.runner_up_tflops <= 0:
            return 0.0
        return self.tflops / self.runner_up_tflops - 1.0

    @property
    def slowdown_vs_dp_of_best_sk(self) -> float:  # pragma: no cover - legacy
        """Deprecated placeholder kept for old artifact readers."""
        return 0.0


@dataclass
class TuningDatabase:
    """Keyed store of tuned winners + per-policy sweep results, with
    snapshot/journal persistence and federation stamps.

    The store partitions per architecture class (:mod:`repro_torch.core.arch`):
    ``records`` holds only this database's own class (``arch``), foreign
    classes live in ``xarch`` keyed by class string. Every ingestion path
    (``add_record``, journal replay, snapshot load, federated merges)
    routes by the *record's* stamped class, so a sibling generation's
    winner can never masquerade as a local measurement — it stays visible
    to the selector only as an ``"xarch"`` re-ranked warm seed."""

    records: Dict[OpKey, TuningRecord] = field(default_factory=dict)
    #: per-key best tflops for every policy (policy name -> tflops); kept so
    #: the Fig-2 tolerance analysis does not need to re-measure.
    per_policy: Dict[OpKey, Dict[str, float]] = field(default_factory=dict)
    #: monotone append counter: bumps on every in-place ``add_record`` /
    #: journal replay, so callers (the adaptive tuner, sieve rebuilds) can
    #: cheaply detect "the database grew since I last looked".
    version: int = 0
    #: records dropped because their key/payload failed to parse (load +
    #: journal replay) — a format skew must be visible, not a silent shrink.
    load_errors: int = 0
    #: installed :class:`~repro_torch.core.calibrate.CalibratedMachine` (or None):
    #: the fitted cost-model constants this database's producer learned from
    #: its journal. Persists through snapshot/journal like records and
    #: federates under the same hybrid (wall, version) LWW stamp.
    calibration: Optional[object] = None
    #: architecture class this database's OWN records were measured on;
    #: anything stamped with a different class routes to ``xarch``.
    arch: str = DEFAULT_ARCH
    #: foreign-class records: class string -> {key -> record}. Never direct
    #: dispatch hits — the selector re-ranks their policies under the local
    #: machine (the ``"xarch"`` source).
    xarch: Dict[str, Dict[OpKey, TuningRecord]] = field(default_factory=dict)
    #: foreign-class calibrations (class string -> CalibratedMachine):
    #: carried for re-federation, never installed as the local scoring fit
    #: — a sibling generation's constants would poison model-first dispatch.
    xarch_calibrations: Dict[str, object] = field(default_factory=dict)
    #: known arch-profile coordinates per class string (from ``{"arch":...}``
    #: journal entries) — observability for merged fleets.
    arch_profiles: Dict[str, ArchProfile] = field(default_factory=dict)

    def winners(self) -> Dict[OpKey, Policy]:
        """{key -> winning Policy} of the OWN arch class — what this
        class's Bloom filters are built from."""
        return {s: policy_from_name(r.policy) for s, r in self.records.items()}

    def build_sieve(
        self,
        capacity: int = 10_000,
        fp_rate: float = 0.01,
        generation: int = 0,
    ) -> OpenSieve:
        """Fresh OpenSieve populated with this database's winners — own
        class under its (legacy-byte-identical) key encoding, foreign
        classes under their class-prefixed encodings, so queries in one
        class never alias another's winners."""
        sieve = OpenSieve(
            ALL_POLICIES, capacity=capacity, fp_rate=fp_rate, generation=generation
        )
        sieve.build_from_winners(self.winners(), arch=self.arch)
        for cls_name, recs in self.xarch.items():
            sieve.build_from_winners(
                {s: policy_from_name(r.policy) for s, r in recs.items()},
                arch=cls_name,
            )
        return sieve

    def n_records(self) -> int:
        """Total records across every arch class (own + foreign)."""
        return len(self.records) + sum(len(v) for v in self.xarch.values())

    def xarch_records_for(self, key: OpKey) -> List[Tuple[str, TuningRecord]]:
        """Foreign-class records for one fingerprint, in deterministic
        class order — the selector's ``"xarch"`` warm-seed source."""
        return [
            (cls_name, recs[key])
            for cls_name, recs in sorted(self.xarch.items())
            if key in recs
        ]

    def note_arch_profile(self, profile: ArchProfile) -> None:
        """Record the coordinates behind an arch class string (idempotent;
        the class string is derived from the profile, so two producers of
        one class cannot disagree)."""
        self.arch_profiles[profile.cls] = profile

    def add_record(
        self,
        rec: TuningRecord,
        per_policy: Optional[Dict[str, float]] = None,
        stamp: bool = True,
    ) -> None:
        """In-place record append (the online-adaptation commit path).
        Overwrites any existing record for the same key and bumps
        ``version`` so sieve-generation machinery sees the change.

        ``stamp`` controls the hybrid commit stamp: fresh local commits
        (the default) arriving unstamped get ``version = clock + 1`` plus
        the current wall clock in ``wall``; replay paths pass
        ``stamp=False`` so a record keeps exactly the (wall, version) its
        producer wrote — in particular a legacy stamp-less journal line
        stays at (0.0, 0) and always loses a federated last-writer-wins
        merge, the same as legacy snapshot records. Already-stamped records
        keep their stamp either way and fast-forward the local clock, so a
        later local commit always outranks them.

        Routing is by the *record's* arch class: own-class records land in
        ``records`` (with their per-policy table), foreign-class records in
        ``xarch`` — the journal-over-snapshot structural precedence
        (unconditional overwrite) holds per class."""
        if stamp and rec.version <= 0:
            rec.version = self.version + 1
            if rec.wall <= 0.0:
                rec.wall = time.time()
        if rec.arch == self.arch:
            self.records[rec.size] = rec
            if per_policy is not None:
                self.per_policy[rec.size] = per_policy
        else:
            self.xarch.setdefault(rec.arch, {})[rec.size] = rec
        self.version = max(self.version + 1, rec.version)

    def set_calibration(self, cm, stamp: bool = True, force: bool = False) -> bool:
        """Install a :class:`~repro_torch.core.calibrate.CalibratedMachine`.

        Mirrors :meth:`add_record`'s stamp semantics: a fresh unstamped
        calibration (the local fit-and-commit path) is stamped with this
        producer's ``(wall, version)`` hybrid clock; replay/merge paths pass
        ``stamp=False`` so the producer's stamp survives. Unless ``force``,
        an incumbent calibration only yields under the deterministic LWW
        order (:func:`repro_torch.core.calibrate.better_calibration`) — the same
        contract records merge under. Returns True when the installed
        calibration changed (bumping ``version`` so sieve-generation
        machinery and adaptive rebuilds see it).

        A calibration stamped with a *foreign* arch class never installs as
        the local fit — it routes to ``xarch_calibrations`` (LWW within its
        class), because a sibling generation's fitted constants would steer
        every local model-first dispatch wrong."""
        from repro_torch.core.calibrate import better_calibration

        cm_arch = getattr(cm, "arch", DEFAULT_ARCH)
        if cm_arch != self.arch:
            cur = self.xarch_calibrations.get(cm_arch)
            new = cm if force else better_calibration(cur, cm)
            if new is cur:
                return False
            self.xarch_calibrations[cm_arch] = new
            return True
        if stamp and cm.version <= 0:
            cm = replace(
                cm,
                version=self.version + 1,
                wall=cm.wall if cm.wall > 0.0 else time.time(),
            )
        if not force and self.calibration is not None:
            cm = better_calibration(self.calibration, cm)
        if cm is self.calibration:
            return False
        self.calibration = cm
        self.version = max(self.version + 1, cm.version)
        return True

    # -- persistence --------------------------------------------------------
    def save(self, path: str) -> None:
        """Write the full JSON snapshot (string-keyed records + sweeps).

        Arch sections (``arch``, ``xarch``, ``arch_profiles``,
        ``xarch_calibrations``) are written only when non-default/non-empty,
        so a single-class default fleet's snapshot stays byte-identical to
        the pre-arch format — and loads under pre-arch readers."""
        payload = {
            "records": {
                key_to_str(s): _record_payload_dict(r)
                for s, r in self.records.items()
            },
            "per_policy": {
                key_to_str(s): pp for s, pp in self.per_policy.items()
            },
        }
        if self.calibration is not None:
            from repro_torch.core.calibrate import calibration_to_json

            payload["calibration"] = calibration_to_json(self.calibration)
        if self.arch != DEFAULT_ARCH:
            payload["arch"] = self.arch
        if self.xarch:
            payload["xarch"] = {
                cls_name: {
                    key_to_str(s): _record_payload_dict(r)
                    for s, r in recs.items()
                }
                for cls_name, recs in self.xarch.items()
            }
        if self.arch_profiles:
            payload["arch_profiles"] = {
                cls_name: p.to_json() for cls_name, p in self.arch_profiles.items()
            }
        if self.xarch_calibrations:
            from repro_torch.core.calibrate import calibration_to_json

            payload["xarch_calibrations"] = {
                cls_name: calibration_to_json(cm)
                for cls_name, cm in self.xarch_calibrations.items()
            }
        with open(path, "w") as f:
            json.dump(payload, f)

    @classmethod
    def load(
        cls,
        path: str,
        journal: Optional[str] = None,
        arch: Optional[str] = None,
    ) -> "TuningDatabase":
        """Load a snapshot, then optionally replay an append-only journal on
        top (records learned after the last snapshot win). Records whose key
        or payload fails to parse are skipped with a warning and counted in
        ``load_errors`` — never silently dropped. Snapshots written before
        the grid sweep carry no ``g``: they parse with ``g = LEGACY_GRID``;
        snapshots written before arch classes parse into ``"default"``.

        ``arch`` overrides the loading process's own class (default: the
        class the snapshot declares). Every record routes by its *own*
        stamped class, so loading another class's snapshot under a local
        class lands its records in ``xarch`` — warm seeds, not direct hits."""
        with open(path) as f:
            payload = json.load(f)
        own = arch if arch is not None else payload.get("arch", DEFAULT_ARCH)
        db = cls(arch=own)
        sections = [(None, payload["records"])]
        sections += [
            (cls_name, recs)
            for cls_name, recs in payload.get("xarch", {}).items()
        ]
        for section_arch, records in sections:
            for key, rec in records.items():
                try:
                    size = key_from_str(key)
                    rec["size"] = size
                    rec.setdefault(
                        "arch",
                        section_arch
                        if section_arch is not None
                        else payload.get("arch", DEFAULT_ARCH),
                    )
                    parsed = TuningRecord(**rec)
                except (ValueError, IndexError, TypeError) as e:
                    db.load_errors += 1
                    log.warning("dropping unparsable tuning record %r: %s", key, e)
                    continue
                if parsed.arch == db.arch:
                    db.records[size] = parsed
                else:
                    db.xarch.setdefault(parsed.arch, {})[size] = parsed
        for key, pp in payload.get("per_policy", {}).items():
            try:
                db.per_policy[key_from_str(key)] = pp
            except (ValueError, IndexError) as e:
                db.load_errors += 1
                log.warning("dropping unparsable per-policy key %r: %s", key, e)
        if payload.get("calibration") is not None:
            from repro_torch.core.calibrate import calibration_from_json

            try:
                # routed by its own arch class: a snapshot re-keyed to a
                # different local class must not install foreign constants
                db.set_calibration(
                    calibration_from_json(payload["calibration"]), stamp=False
                )
            except (ValueError, KeyError, TypeError) as e:
                db.load_errors += 1
                log.warning("dropping unparsable calibration: %s", e)
        for cls_name, cal in payload.get("xarch_calibrations", {}).items():
            from repro_torch.core.calibrate import calibration_from_json

            try:
                db.set_calibration(calibration_from_json(cal), stamp=False)
            except (ValueError, KeyError, TypeError) as e:
                db.load_errors += 1
                log.warning(
                    "dropping unparsable %s calibration: %s", cls_name, e
                )
        for cls_name, prof in payload.get("arch_profiles", {}).items():
            try:
                db.note_arch_profile(ArchProfile.from_json(prof))
            except (ValueError, TypeError) as e:
                db.load_errors += 1
                log.warning("dropping unparsable arch profile %r: %s", cls_name, e)
        if db.load_errors:
            log.warning(
                "%s: dropped %d unparsable entries (kept %d records) — "
                "journal/db format skew?",
                path,
                db.load_errors,
                len(db.records),
            )
        # resume the producer's commit clock so post-load commits outrank
        # every loaded record in a federated merge
        db.version = max((r.version for r in db.records.values()), default=0)
        if db.calibration is not None:
            db.version = max(db.version, db.calibration.version)
        if journal is not None:
            db.replay_journal(journal, missing_ok=True)
        return db

    def replay_journal(self, path: str, missing_ok: bool = False) -> int:
        """Re-apply an append-only JSONL journal (see :func:`journal_entry`)
        in order; later lines win. Returns the number of entries applied;
        malformed lines are warned about and counted in ``load_errors``.
        Legacy g-less lines replay with ``g = LEGACY_GRID``; arch-less
        lines into the ``"default"`` class.

        Entries route through the tagged-entry registry
        (:data:`JOURNAL_ENTRY_HANDLERS`): an entry whose tag no handler
        claims — a *future* producer's type — is skipped and counted in
        ``load_errors`` but NOT warned as malformed (forward compatibility
        is not corruption).

        Crash tolerance: a process dying mid-``append_journal`` leaves a
        truncated final line — possibly ending inside a multi-byte UTF-8
        sequence, which is why the file is read as bytes and decoded per
        line (text-mode iteration would raise ``UnicodeDecodeError`` before
        any handler ran). The torn line is skipped with a warning and
        counted in ``load_errors``; every complete line before it replays
        normally."""
        try:
            f = open(path, "rb")
        except FileNotFoundError:
            if missing_ok:
                return 0
            raise
        with f:
            raw_lines = f.read().split(b"\n")
        last_lineno = max(
            (i for i, raw in enumerate(raw_lines, 1) if raw.strip()), default=0
        )
        applied = 0
        for lineno, raw in enumerate(raw_lines, 1):
            if not raw.strip():
                continue
            try:
                entry = json.loads(raw.decode("utf-8"))
                if apply_journal_entry(self, entry):
                    applied += 1
                else:
                    # unknown tag: a future entry type, not corruption —
                    # counted (the shrink stays visible) but not warned
                    self.load_errors += 1
                    log.debug(
                        "%s:%d: skipping journal entry with unknown tag "
                        "(keys %s)",
                        path,
                        lineno,
                        sorted(entry)[:4] if isinstance(entry, dict) else "-",
                    )
            except (ValueError, IndexError, TypeError, KeyError) as e:
                self.load_errors += 1
                if lineno == last_lineno:
                    log.warning(
                        "%s:%d: skipping truncated final journal line "
                        "(crash during append?): %s",
                        path,
                        lineno,
                        e,
                    )
                else:
                    log.warning(
                        "%s:%d: skipping malformed journal line: %s",
                        path,
                        lineno,
                        e,
                    )
        return applied


def _entry_record(entry: dict) -> Tuple[TuningRecord, Optional[Dict[str, float]]]:
    """(record, per_policy) from a decoded record-type journal entry."""
    size = key_from_str(entry["key"])
    rec = dict(entry["record"])
    rec.pop("size", None)
    return TuningRecord(size=size, **rec), entry.get("per_policy")


def _record_payload_dict(rec: TuningRecord) -> dict:
    """Record dict for snapshots/journals: the ``arch`` field is omitted
    for default-class records, so a single-class default fleet's artifact
    bytes stay identical to the pre-arch formats (and stay readable by
    pre-arch consumers, which reject unknown record fields)."""
    d = asdict(rec)
    if rec.arch == DEFAULT_ARCH:
        d.pop("arch", None)
    return d


# -- tagged journal entries -------------------------------------------------
#
# The journal carries three entry types ({"record": ...}, {"calibration":
# ...}, {"arch": ...}); this registry makes the codec table-driven: one
# handler per tag, checked in registration order
# (``"record"`` first — record entries also carry "key"/"per_policy" keys).
# Producers of NEW types register here; consumers built before a type
# existed skip-and-count it instead of warning (see ``replay_journal``).


def _apply_record_entry(db: "TuningDatabase", entry: dict) -> None:
    rec, per_policy = _entry_record(entry)
    # stamp=False: replay reconstructs producer state — legacy version-less
    # lines must stay 0 (and lose merges), not become fresh local commits
    db.add_record(rec, per_policy, stamp=False)


def _apply_calibration_entry(db: "TuningDatabase", entry: dict) -> None:
    from repro_torch.core.calibrate import calibration_from_json

    # replayed under the same LWW order as merges, producer stamp preserved
    db.set_calibration(calibration_from_json(entry["calibration"]), stamp=False)


def _apply_arch_entry(db: "TuningDatabase", entry: dict) -> None:
    db.note_arch_profile(ArchProfile.from_json(entry["arch"]))


#: tag -> handler(db, entry). Insertion order is match order.
JOURNAL_ENTRY_HANDLERS: Dict[str, Callable[["TuningDatabase", dict], None]] = {
    "record": _apply_record_entry,
    "calibration": _apply_calibration_entry,
    "arch": _apply_arch_entry,
}


def register_journal_entry(
    tag: str, handler: Callable[["TuningDatabase", dict], None]
) -> None:
    """Register a journal entry type: ``handler(db, entry)`` is called for
    every journal line whose decoded object carries ``tag`` as a key.
    Raising from the handler marks the line malformed (warn + count);
    see :meth:`TuningDatabase.replay_journal`."""
    JOURNAL_ENTRY_HANDLERS[tag] = handler


def apply_journal_entry(db: "TuningDatabase", entry) -> bool:
    """Apply ONE decoded journal entry through the tag registry.

    Returns True when a handler claimed and applied it, False for an
    unknown tag (the caller decides how to count forward-compat skips).
    Raises — like the handlers — on a malformed payload. Shared by
    ``replay_journal`` and the streaming :mod:`repro_torch.core.gossip` reader,
    so both consume exactly the same entry table."""
    if not isinstance(entry, dict):
        raise ValueError(f"journal entry is not an object: {type(entry).__name__}")
    for tag, handler in JOURNAL_ENTRY_HANDLERS.items():
        if tag in entry:
            handler(db, entry)
            return True
    return False


def parse_journal_line(line: str) -> Tuple[TuningRecord, Optional[Dict[str, float]]]:
    """Parse one record-type journal line into (record, per_policy). Raises
    on any malformed input (``replay_journal`` / shard mergers decide whether
    that is fatal). Legacy lines parse with ``g = LEGACY_GRID``/``version =
    0``. Calibration entries are not records — ``replay_journal`` routes
    them to :meth:`TuningDatabase.set_calibration` instead."""
    return _entry_record(json.loads(line))


def journal_entry(
    rec: TuningRecord, per_policy: Optional[Dict[str, float]] = None
) -> str:
    """One journal line: the shared format the offline ``Tuner`` emits and
    the serve-time adaptive tuner appends — ``TuningDatabase.replay_journal``
    consumes both identically. Default-class records serialize without the
    ``arch`` field (byte-identical to pre-arch lines)."""
    payload = _record_payload_dict(rec)
    payload.pop("size")
    entry = {"key": key_to_str(rec.size), "record": payload}
    if per_policy is not None:
        entry["per_policy"] = per_policy
    return json.dumps(entry)


def append_journal(
    path: str, rec: TuningRecord, per_policy: Optional[Dict[str, float]] = None
) -> None:
    """Append one record to the JSONL journal (crash-safe: one line per
    commit, flushed before close; a torn final line is skipped on replay)."""
    with open(path, "a") as f:
        f.write(journal_entry(rec, per_policy) + "\n")


def measure_model(mach: costmodel.Machine = costmodel.V5E) -> MeasureFn:
    """Measurement oracle backed by the analytical cost model."""

    def fn(
        shape: GemmShape,
        policy: Policy,
        cfg: TileConfig,
        g: int,
        dt: DtypeBytes,
    ) -> float:
        return costmodel.gemm_tflops(shape, cfg, policy, mach, g, dt)

    return fn


def measure_wallclock(
    warmup: int = 50, iters: int = 50, device=None
) -> MeasureFn:
    """The paper's protocol on the card: ``warmup`` launches, then the
    average of ``iters`` timed back to back between two CUDA events on the
    current stream. Only the port's hand-written kernels run: a plain target
    through :func:`repro_torch.kernels.streamk.ops.gemm`, a fused grouped one
    through :func:`~repro_torch.kernels.streamk.grouped.gemm_grouped_streamk`,
    each with the swept (policy, cfg, g) — never a library matmul. Operand
    dtypes follow the target's :class:`DtypeBytes` profile as the JAX
    package maps them; the operands come from a ``torch.Generator`` seeded
    0 on the device. The weights stay in L2 between launches, as in the JAX
    package's protocol, so these times are not comparable with
    ``chip_smoke.py``'s kernel table, which rotates them past it.

    Raises when ``device`` is not a CUDA device (there is no CPU fallback)
    and, at measure time, for an operand pair the kernels do not take
    (:data:`~repro_torch.kernels.common.CUDA_PAIRS`). The returned function
    keeps its last call's ``(a, b, c)`` in ``fn.last`` for checks."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "measure_wallclock times the CUDA kernels and no CUDA device is "
                "available; measure_model is the CPU oracle"
            )
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(
            f"measure_wallclock times the CUDA kernels; got device {device} "
            "(there is no CPU fallback)"
        )

    from repro_torch.kernels.common import CUDA_PAIRS
    from repro_torch.kernels.streamk import ops as sk_ops
    from repro_torch.kernels.streamk.grouped import gemm_grouped_streamk

    width_to_dtype = {1: torch.int8, 2: torch.bfloat16, 4: torch.float32}

    def _dt_dtype(width):
        if width == 8:
            # the kernels take no f64 operands — measure what will actually
            # run and say so, instead of recording an "f64" winner that
            # never timed f64 kernels
            log.warning("no f64 kernels: measuring 8-byte fingerprint at float32")
            return torch.float32
        if width < 1:
            # sub-byte packed fingerprints (int4 at 0.5 bytes/element) time
            # the int8 stand-in, as the JAX package does — an upper bound on
            # the packed kernel's B traffic; honest on compute, conservative
            # on bandwidth
            log.warning(
                "measuring sub-byte (%.1f-byte) fingerprint with int8 "
                "operands — timings upper-bound the packed kernel",
                width,
            )
            return torch.int8
        if width == 1:
            # byte-wide fingerprints (int8, fp8 variants) all time the int8
            # stand-in; fp8 records therefore reflect int8 kernel timing
            log.warning("measuring 1-byte fingerprint with int8 operands")
        return width_to_dtype.get(width, torch.float32)

    def _operand(shape, dt, gen):
        x = torch.randn(shape, generator=gen, device=device)
        return x.to(dt)

    def fn(
        shape: GemmShape,
        policy: Policy,
        cfg: TileConfig,
        g: int,
        dt: DtypeBytes,
    ) -> float:
        a_dtype = _dt_dtype(dt.a)
        b_dtype = _dt_dtype(dt.b)
        out_dtype = _dt_dtype(dt.out)
        if (a_dtype, b_dtype, 8) not in CUDA_PAIRS or out_dtype not in (
            torch.float32,
            torch.bfloat16,
        ):
            raise NotImplementedError(
                f"no CUDA kernel takes {a_dtype} @ {b_dtype} -> {out_dtype} "
                f"(profile {dt})"
            )
        gen = torch.Generator(device=device).manual_seed(0)
        groups = getattr(shape, "groups", 1)
        # int8 x int8 passes no per-row scale_a, as the JAX package does:
        # the kernels skip that epilogue stage when it is absent
        if groups > 1:
            # fused grouped target: time the one-kernel concatenated form
            # with stacked per-expert operands — the kernel the dispatcher
            # actually launches for this fingerprint
            a = _operand((groups, shape.m, shape.k), a_dtype, gen)
            b = _operand((groups, shape.k, shape.n), b_dtype, gen)

            def call():
                return gemm_grouped_streamk(
                    a, b, policy=policy, cfg=cfg, g=g, out_dtype=out_dtype
                )
        else:
            a = _operand((shape.m, shape.k), a_dtype, gen)
            b = _operand((shape.k, shape.n), b_dtype, gen)

            def call():
                return sk_ops.gemm(
                    a, b, policy=policy, cfg=cfg, g=g, out_dtype=out_dtype
                )

        stream = torch.cuda.current_stream(device)
        for _ in range(warmup):
            call()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        for _ in range(iters):
            out = call()
        end.record(stream)
        end.synchronize()
        fn.last = (a, b, out)
        dt_s = start.elapsed_time(end) / 1e3 / iters
        return shape.flops / dt_s / 1e12

    fn.last = None
    return fn


def shard_targets(sizes: Sequence, index: int, n_shards: int) -> List:
    """Worker ``index``'s slice of a sweep: every ``n_shards``-th target
    starting at ``index``. Strided (not contiguous) so the suite's
    size-sorted cost profile balances across workers; the ``n_shards``
    slices are disjoint and cover ``sizes`` exactly, which is what makes a
    federated merge record-identical to the single-worker full sweep."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if not 0 <= index < n_shards:
        raise ValueError(f"shard index {index} outside [0, {n_shards})")
    return list(sizes)[index::n_shards]


class Tuner:
    """Sweep (policy x tile config x grid size) per problem size; record
    winner and runner-up (runner-up = best configuration of the *second-best
    policy*, which is what the paper's Fig. 3 violin compares against).

    Two sweep budgets:

      * ``top_k=None`` (default) — the exhaustive oracle: every feasible
        (policy, cfg, g) is measured, exactly the classic ckProfiler sweep.
      * ``top_k=k`` — the analytical-first budget: only the cost model's
        top-k ranked candidates (:func:`costmodel.rank_candidates`, under
        the installed ``calibration``'s machine when one is set) are
        measured, plus DP's best-ranked candidate (so ``dp_best_tflops``
        stays honest) and at least one candidate of a second policy (so the
        runner-up field stays meaningful) — ~k+2 measurements instead of
        ~|policies| x |cfgs| x |grids|. Each record notes the measured
        winner's model rank, the drift signal calibration quality is judged
        by.

    ``measurements`` counts every ``measure_fn`` call across the tuner's
    lifetime — the budget the top-k acceptance criterion compares."""

    def __init__(
        self,
        policies: Sequence[Policy] = ALL_POLICIES,
        tile_configs: Sequence[TileConfig] = DEFAULT_TILE_CONFIGS,
        measure_fn: Optional[MeasureFn] = None,
        mach: costmodel.Machine = costmodel.V5E,
        grid_sizes: Optional[Sequence[int]] = None,
        top_k: Optional[int] = None,
        calibration=None,
        arch: str = DEFAULT_ARCH,
    ):
        if top_k is not None and top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        #: arch class stamped onto every record this tuner measures (the
        #: machine class the measurements describe — see repro_torch.core.arch)
        self.arch = arch
        self.policies = tuple(policies)
        self.tile_configs = tuple(tile_configs)
        self.measure = measure_fn or measure_model(mach)
        self.mach = mach
        self.grid_sizes = (
            tuple(grid_sizes)
            if grid_sizes is not None
            else costmodel.default_grid_sizes(mach)
        )
        self.top_k = top_k
        self.calibration = calibration
        self.measurements = 0

    def _rank_machine(self, dt: DtypeBytes) -> costmodel.Machine:
        """Machine the model ranks candidates under: the calibration's
        per-profile fit when installed, the nominal machine otherwise."""
        if self.calibration is not None:
            return self.calibration.machine_for(dt)
        return self.mach

    def _ranked(self, shape: GemmShape, dt: DtypeBytes):
        return costmodel.rank_candidates(
            shape,
            self._rank_machine(dt),
            self.policies,
            self.tile_configs,
            self.grid_sizes,
            dt,
        )

    def _model_rank(
        self, shape: GemmShape, dt: DtypeBytes, policy: str, cfg: str, g: int
    ) -> int:
        """1-based model rank of a (policy, cfg, g) pick (-1 if unranked)."""
        for i, (pol, c, gg, _) in enumerate(self._ranked(shape, dt), 1):
            if pol.name == policy and c.name == cfg and gg == g:
                return i
        return -1

    @staticmethod
    def _runner_up(ranked_pols: List[Tuple[str, float]]) -> Tuple[str, float]:
        """Runner-up = best policy with strictly lower measured performance
        (the deterministic cost model produces exact ties between sibling
        schedules — e.g. HYBRID(b) variants whose extra batches are moot —
        which real-hardware noise would separate; Fig.3 compares against
        the next *distinct* configuration)."""
        w_name, w_tf = ranked_pols[0]
        r_name, r_tf = ranked_pols[1] if len(ranked_pols) > 1 else (w_name, 0.0)
        for name, tf in ranked_pols[1:]:
            if tf < w_tf * (1 - 1e-9):
                r_name, r_tf = name, tf
                break
        return r_name, r_tf

    def _record(
        self,
        key: OpKey,
        shape: GemmShape,
        dt: DtypeBytes,
        per_policy: Dict[str, float],
        per_policy_cfg: Dict[str, str],
        per_policy_g: Dict[str, int],
    ) -> TuningRecord:
        ranked = sorted(per_policy.items(), key=lambda kv: kv[1], reverse=True)
        w_name, w_tf = ranked[0]
        r_name, r_tf = self._runner_up(ranked)
        return TuningRecord(
            size=key,
            policy=w_name,
            cfg=per_policy_cfg[w_name],
            tflops=w_tf,
            runner_up_policy=r_name,
            runner_up_tflops=r_tf,
            dp_best_tflops=per_policy.get(DP.name, 0.0),
            g=per_policy_g[w_name],
            model_rank=self._model_rank(
                shape, dt, w_name, per_policy_cfg[w_name], per_policy_g[w_name]
            ),
            arch=self.arch,
        )

    def _tune_size_full(
        self, key: OpKey, shape: GemmShape, dt: DtypeBytes
    ) -> Tuple[TuningRecord, Dict[str, float]]:
        """The exhaustive oracle sweep: every feasible (policy, cfg, g)."""
        per_policy: Dict[str, float] = {}
        per_policy_cfg: Dict[str, str] = {}
        per_policy_g: Dict[str, int] = {}
        for pol in self.policies:
            best = -1.0
            best_cfg = self.tile_configs[0]
            best_g = self.grid_sizes[0]
            for g in self.grid_sizes:
                for cfg in self.tile_configs:
                    if costmodel.vmem_working_set(cfg, dt) > self.mach.vmem_bytes:
                        continue
                    tf = self.measure(shape, pol, cfg, g, dt)
                    self.measurements += 1
                    if tf > best:
                        best, best_cfg, best_g = tf, cfg, g
            per_policy[pol.name] = best
            per_policy_cfg[pol.name] = best_cfg.name
            per_policy_g[pol.name] = best_g
        rec = self._record(key, shape, dt, per_policy, per_policy_cfg, per_policy_g)
        return rec, per_policy

    def _tune_size_topk(
        self, key: OpKey, shape: GemmShape, dt: DtypeBytes
    ) -> Tuple[TuningRecord, Dict[str, float]]:
        """The budgeted model-first sweep: measure only the cost model's
        top-k candidates (+ DP's best-ranked, + one second-policy candidate
        when the head is single-policy)."""
        ranked = self._ranked(shape, dt)
        cand = list(ranked[: self.top_k])
        have = {(c[0].name, c[1].name, c[2]) for c in cand}
        pols = {c[0].name for c in cand}
        # dp_best_tflops is the paper's tolerance baseline — always measure
        # DP's best-ranked candidate even when it falls outside the head
        if DP in self.policies and DP.name not in pols:
            dp_c = next((c for c in ranked if c[0] is DP), None)
            if dp_c is not None and (DP.name, dp_c[1].name, dp_c[2]) not in have:
                cand.append(dp_c)
                have.add((DP.name, dp_c[1].name, dp_c[2]))
                pols.add(DP.name)
        # a meaningful runner-up needs a second distinct policy in budget
        if len(pols) < 2:
            alt = next((c for c in ranked if c[0].name not in pols), None)
            if alt is not None:
                cand.append(alt)
                pols.add(alt[0].name)
        per_policy: Dict[str, float] = {}
        per_policy_cfg: Dict[str, str] = {}
        per_policy_g: Dict[str, int] = {}
        for pol, cfg, g, _ in cand:
            tf = self.measure(shape, pol, cfg, g, dt)
            self.measurements += 1
            if tf > per_policy.get(pol.name, -1.0):
                per_policy[pol.name] = tf
                per_policy_cfg[pol.name] = cfg.name
                per_policy_g[pol.name] = g
        rec = self._record(key, shape, dt, per_policy, per_policy_cfg, per_policy_g)
        return rec, per_policy

    def tune_size(self, size) -> Tuple[TuningRecord, Dict[str, float]]:
        """Sweep one tuning target — a bare (M, N, K) or a full GemmOp
        (grouped / fused ops tune per-group on their local shape and record
        under their op-fingerprint key, measured at their real operand
        byte-widths). ``top_k`` picks the budget (see class docstring)."""
        key = _as_key(size)
        shape = _key_shape(size, key)
        dt = _target_dtypes(size)
        if self.top_k is not None:
            return self._tune_size_topk(key, shape, dt)
        return self._tune_size_full(key, shape, dt)

    def tune(
        self,
        sizes: Sequence,
        progress_every: int = 0,
        journal: Optional[str] = None,
        shard: Optional[Tuple[int, int]] = None,
    ) -> TuningDatabase:
        """Tune a suite of targets (bare (M, N, K) sizes and/or GemmOps).
        With ``journal``, each record is also appended to the JSONL journal
        as it lands — the same format the online adaptive tuner emits, so an
        offline sweep and a serving run can share one warm-start artifact.

        ``shard=(i, n)`` restricts the sweep to worker ``i``'s slice of the
        target list (see :func:`shard_targets`): n workers each tune their
        own slice — journaling to their own shard file — and
        :func:`~repro_torch.core.federate.merge_journal_shards` reassembles
        the unsharded sweep's database."""
        if shard is not None:
            sizes = shard_targets(sizes, *shard)
        db = TuningDatabase(arch=self.arch)
        for i, size in enumerate(sizes):
            rec, per_policy = self.tune_size(size)
            db.add_record(rec, per_policy)
            if journal is not None:
                append_journal(journal, rec, per_policy)
            if progress_every and (i + 1) % progress_every == 0:  # pragma: no cover
                print(f"tuned {i + 1}/{len(sizes)}")
        return db
