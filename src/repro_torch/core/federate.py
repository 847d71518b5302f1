"""Federated tuning: merge what N workers learned into one selection state
(the port's copy of ``repro.core.federate``, whose journals, records and
sieve bytes it reads and writes unchanged).

The offline :class:`~repro_torch.core.tuner.Tuner` shards a sweep across workers
(``Tuner.tune(shard=(i, n))``) and serving processes each append to their own
journal shard; this module is the reassembly layer that turns those partial
artifacts back into ONE :class:`~repro_torch.core.tuner.TuningDatabase` + one
:class:`~repro_torch.core.opensieve.OpenSieve`, so every worker's next
:meth:`~repro_torch.core.selector.KernelSelector.hot_swap` dispatches from the
union instead of re-discovering what a sibling already tuned.

Merge semantics:

  * **Records** — last-writer-wins per fingerprint key on the record's
    hybrid ``(wall, version)`` commit stamp: the wall clock orders commits
    *across* producers (a true time order, up to host clock sync), the
    producer's ``version`` counter breaks sub-resolution ties *within*
    one. A full stamp tie between *differing* payloads is a real conflict
    (two workers tuned the same fingerprint at indistinguishable times):
    it is counted in ``MergeReport.conflicts`` and resolved
    deterministically — higher measured tflops, then policy / cfg / g name
    order — so the merged database is identical whatever order the shards
    arrive in. Records that lose are counted in ``superseded``. Sharded
    sweeps partition fingerprints disjointly, so an offline federated
    sweep merges with zero conflicts and is record-identical (modulo local
    commit stamps) to the single-worker full sweep.

    Clock caveat: the wall half of the stamp is only as good as host clock
    sync; where a *structural* precedence exists it still wins outright —
    journals replay *on top of* the snapshot they post-date
    (``apply_journal_db`` / ``TuningDatabase.load(path, journal=...)``
    overwrite unconditionally, whatever either side's stamps say), and
    ``federate_selector`` merges into the worker's live database, whose
    records stand unless a sibling's strictly outranks them. Artifacts
    written before the hybrid stamp parse with ``wall = 0.0`` and lose to
    any wall-stamped record.
  * **Sieves** — :meth:`OpenSieve.merge` bitwise-ORs the per-policy Bloom
    filters (inserting a key sets the same bits whichever worker's filter it
    landed in, so the union is bit-identical to rebuilding from the merged
    winner map) and bumps ``generation`` past every input, which is what
    makes selector hot-swaps drop picks memoised under any pre-merge sieve.
  * **Journals** — each shard replays into its own staging database first
    (preserving intra-shard time order and producer version stamps), then
    databases merge as above. Torn/malformed lines are skipped and summed
    into ``MergeReport.load_errors`` (see ``replay_journal``).

Every merge partitions per architecture class (:mod:`repro_torch.core.arch`):
last-writer-wins plays out *within* a class (the ``into`` database's own
class in ``records``, every foreign class in its ``xarch`` bucket), so a
record tuned on a different machine generation can never supersede — or be
superseded by — a local measurement. Single-class fleets (including every
legacy arch-less artifact, which parses into ``"default"``) merge exactly
as before, byte for byte.

``federate_selector`` is the worker-side entry point: merge everything that
arrived from the fleet into this worker's selector and hot-swap, after which
a fingerprint tuned in any same-class sibling dispatches here as a database
hit — no miss, no re-tune — while other-class imports surface as ``"xarch"``
re-ranked warm seeds.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.arch import DEFAULT_ARCH
from repro_torch.core.bloom import optimal_params
from repro_torch.core.op import OpKey
from repro_torch.core.opensieve import OpenSieve
from repro_torch.core.policies import policy_from_name
from repro_torch.core.selector import KernelSelector, SelectorState
from repro_torch.core.tuner import TuningDatabase, TuningRecord
from repro_torch.utils.logging import get_logger

log = get_logger("federate")


@dataclass
class MergeReport:
    """What a federated merge did — the observability surface CI and the
    serve CLI print, so shard skew is a number rather than a mystery."""

    sources: int = 0  # databases / journal shards consumed
    examined: int = 0  # records read across all sources
    merged: int = 0  # distinct fingerprint keys in the result
    conflicts: int = 0  # same key, same version, DIFFERENT payload
    superseded: int = 0  # records that lost last-writer-wins
    load_errors: int = 0  # malformed/torn journal lines skipped

    def combine(self, other: "MergeReport") -> "MergeReport":
        """Fold two reports (additive counters; ``merged`` takes the max)."""
        return MergeReport(
            sources=self.sources + other.sources,
            examined=self.examined + other.examined,
            merged=max(self.merged, other.merged),
            conflicts=self.conflicts + other.conflicts,
            superseded=self.superseded + other.superseded,
            load_errors=self.load_errors + other.load_errors,
        )


def record_payload(rec: TuningRecord) -> TuningRecord:
    """The record with its hybrid commit stamp zeroed — what two workers
    must agree on for their records to count as the *same* result. Sharded
    sweeps of one suite produce per-shard clocks and per-run wall stamps,
    so equality checks (and conflict detection) must ignore both
    ``version`` and ``wall``."""
    return dataclasses.replace(rec, version=0, wall=0.0)


def _stamp(rec: TuningRecord) -> Tuple[float, int]:
    """The hybrid commit stamp last-writer-wins orders on: wall clock
    first (comparable across producers), producer version counter second
    (breaks sub-resolution ties within one producer; sole order for
    legacy wall-less artifacts, which all carry wall 0.0)."""
    return (rec.wall, rec.version)


def _wins(challenger: TuningRecord, incumbent: TuningRecord) -> bool:
    """Deterministic total order for last-writer-wins: the hybrid
    (wall, version) stamp first, then measured tflops, then
    (policy, cfg, g) name order as the final arbitrary-but-stable
    tiebreak. Symmetric: merge order never changes the winner."""
    return (
        *_stamp(challenger),
        challenger.tflops,
        challenger.policy,
        challenger.cfg,
        challenger.g,
    ) > (
        *_stamp(incumbent),
        incumbent.tflops,
        incumbent.policy,
        incumbent.cfg,
        incumbent.g,
    )


def merge_records(
    into: TuningDatabase,
    records: Iterable[Tuple[TuningRecord, Optional[Dict[str, float]]]],
    report: Optional[MergeReport] = None,
) -> MergeReport:
    """Fold (record, per_policy) pairs into ``into`` under last-writer-wins.
    Mutates ``into`` (bumping its ``version`` clock past every applied
    record) and returns the report.

    Last-writer-wins plays out per arch class: a record routes into
    ``into.records`` (its class matches ``into.arch``) or the matching
    ``into.xarch`` bucket, and only contends with incumbents of its OWN
    class — cross-class supersession is impossible by construction. The
    per-policy sweep table only ever describes own-class records."""
    report = report if report is not None else MergeReport()
    for rec, per_policy in records:
        report.examined += 1
        own_class = rec.arch == into.arch
        bucket = into.records if own_class else into.xarch.setdefault(rec.arch, {})
        cur = bucket.get(rec.size)
        if cur is not None and record_payload(cur) != record_payload(rec):
            if _stamp(cur) == _stamp(rec):
                report.conflicts += 1
            report.superseded += 1
        if cur is None or _wins(rec, cur):
            bucket[rec.size] = rec
            # the per-policy table must describe the stored record: install
            # the winner's (when it has one) or drop the loser's stale one
            # — fig2-tolerance-style consumers must never read measurements
            # that belong to a superseded record
            if own_class:
                if per_policy is not None:
                    into.per_policy[rec.size] = per_policy
                elif cur is not None and record_payload(cur) != record_payload(rec):
                    into.per_policy.pop(rec.size, None)
            into.version = max(into.version, rec.version)
    report.merged = into.n_records()
    return report


def merge_databases(
    dbs: Sequence[TuningDatabase],
    into: Optional[TuningDatabase] = None,
) -> Tuple[TuningDatabase, MergeReport]:
    """Merge N workers' databases into one (inputs are not mutated unless
    one of them is passed as ``into``). Sources may carry any mix of arch
    classes — every record (own and ``xarch``) re-routes against the
    result's class, so heterogeneous fleets fold into one database whose
    ``records`` stay pure local-class."""
    out = into if into is not None else TuningDatabase()
    report = MergeReport(sources=len(dbs))
    for db in dbs:
        all_records = [
            (rec, db.per_policy.get(key)) for key, rec in db.records.items()
        ] + [
            (rec, None)
            for recs in db.xarch.values()
            for rec in recs.values()
        ]
        merge_records(out, all_records, report)
        report.load_errors += db.load_errors
        if db.calibration is not None:
            # calibrations LWW-merge under the same hybrid (wall, version)
            # stamp as records (ties broken deterministically — see
            # calibrate.better_calibration), so the fleet converges on one
            # fitted machine PER ARCH CLASS whatever order shards arrive in
            # (set_calibration routes foreign-class fits to
            # ``xarch_calibrations`` — they never steer the local model)
            had = out.calibration
            out.set_calibration(db.calibration, stamp=False)
            if (
                getattr(db.calibration, "arch", DEFAULT_ARCH) == out.arch
                and had is not None
                and dataclasses.replace(had, wall=0.0, version=0)
                != dataclasses.replace(db.calibration, wall=0.0, version=0)
            ):
                report.superseded += 1  # one of the two differing fits lost
        for cm in db.xarch_calibrations.values():
            out.set_calibration(cm, stamp=False)
        out.arch_profiles.update(db.arch_profiles)
    return out, report


def merge_journal_shards(
    paths: Sequence[str],
    into: Optional[TuningDatabase] = None,
    missing_ok: bool = False,
) -> Tuple[TuningDatabase, MergeReport]:
    """Reassemble journal shards (one append-only JSONL per worker) into one
    database. Each shard replays into its own staging database first — that
    preserves intra-shard commit order (later lines win within a shard) and
    the producers' version stamps — then staging databases merge under
    last-writer-wins. Torn final lines and malformed lines are skipped and
    totalled in the report (``replay_journal`` semantics). Staging databases
    adopt the target's arch class so stamped records route identically
    whether they replay here or directly into the target."""
    own_arch = into.arch if into is not None else DEFAULT_ARCH
    staged: List[TuningDatabase] = []
    for path in paths:
        db = TuningDatabase(arch=own_arch)
        db.replay_journal(path, missing_ok=missing_ok)
        staged.append(db)
    out, report = merge_databases(staged, into=into)
    report.sources = len(paths)
    return out, report


def apply_journal_db(
    into: TuningDatabase, journal_db: TuningDatabase
) -> TuningDatabase:
    """Apply journal-derived records ON TOP of a snapshot database —
    unconditional overwrite, the ``TuningDatabase.load(path, journal=...)``
    contract: a journal post-dates the snapshot it accompanies, so its
    records win regardless of commit stamps. The structural precedence is
    deliberate even now that stamps carry a wall clock: a snapshot
    regenerated on a skewed (or simply later-running) host must never
    outrank the online commits its own journal recorded after it.
    Producer stamps are preserved; the clock fast-forwards. The overwrite
    is per arch class: foreign-class journal records land in (and only
    displace within) their ``xarch`` bucket."""
    for key, rec in journal_db.records.items():
        pp = journal_db.per_policy.get(key)
        if pp is None and rec.arch == into.arch and key in into.per_policy:
            cur = into.records.get(key)
            if cur is None or record_payload(cur) != record_payload(rec):
                into.per_policy.pop(key, None)  # must not describe the loser
        into.add_record(rec, pp, stamp=False)
    for recs in journal_db.xarch.values():
        for rec in recs.values():
            into.add_record(rec, None, stamp=False)
    if journal_db.calibration is not None:
        # same structural precedence as records: the journal post-dates the
        # snapshot it accompanies, so its calibration wins outright (routed
        # per class — a foreign-class fit forces only its own bucket)
        into.set_calibration(journal_db.calibration, stamp=False, force=True)
    for cm in journal_db.xarch_calibrations.values():
        into.set_calibration(cm, stamp=False)
    into.arch_profiles.update(journal_db.arch_profiles)
    into.load_errors += journal_db.load_errors
    return into


def merge_sieves(
    sieves: Sequence[OpenSieve], generation: Optional[int] = None
) -> OpenSieve:
    """Union N workers' sieves (see :meth:`OpenSieve.merge`); the result's
    generation lands past every input so hot-swap consumers re-resolve.
    Always returns a detached sieve — inputs are never aliased or mutated,
    so a worker's live sieve keeps serving while the union is assembled."""
    if not sieves:
        raise ValueError("merge_sieves needs at least one sieve")
    out = OpenSieve.from_bytes(sieves[0].to_bytes())  # detached copy
    out.policies = sieves[0].policies
    out.capacity = sieves[0].capacity
    out.fp_rate = sieves[0].fp_rate
    for s in sieves[1:]:
        out = out.merge(s, generation=0)
    out.generation = (
        generation
        if generation is not None
        else max(s.generation for s in sieves) + 1
    )
    return out


def _sieve_geometry(sieve: Optional[OpenSieve]) -> Optional[Tuple[int, int]]:
    """(n_bits, n_hashes) of a sieve's filters (None when unknowable)."""
    if sieve is None:
        return None
    for f in sieve.filters.values():
        return (f.n_bits, f.n_hashes)
    return None


def federate_selector(
    selector: KernelSelector,
    dbs: Sequence[TuningDatabase] = (),
    journals: Sequence[str] = (),
    sieves: Sequence[OpenSieve] = (),
    capacity: Optional[int] = None,
    fp_rate: Optional[float] = None,
    missing_ok: bool = False,
) -> SelectorState:
    """Fold fleet state into one worker's selector and hot-swap.

    The worker's own database is the merge base (its in-process commits keep
    last-writer-wins standing against stale fleet copies); sibling databases
    and journal shards fold in on top, partitioned per arch class. The new
    sieve is built under ``max(every input generation, selector's) + 1`` —
    either by unioning the supplied sibling ``sieves`` and folding in any
    merged winners they have not seen, or by rebuilding from the merged
    database — and the hot-swap drops every memoised pick, so the very next
    dispatch of a fingerprint tuned in a same-class sibling resolves as a
    database hit here (other classes: an ``"xarch"`` warm seed).

    ``capacity``/``fp_rate`` default to the geometry of the selector's
    *installed* sieve — historical fixed defaults could silently rebuild a
    sieve whose Bloom parameters disagreed with what the worker was serving
    (poisoning any later :meth:`OpenSieve.merge`). Passing them explicitly
    against a mismatched installed sieve raises the merge error up front,
    with both configurations named, instead of deep inside a later union.

    Installs — and returns — the :class:`~repro_torch.core.selector.SelectorState`
    snapshot; the :class:`MergeReport` rides along as ``state.report`` (and
    via delegation: ``state.merged``, ``state.conflicts``, ...)."""
    own_sieve = selector.sieve
    explicit = capacity is not None or fp_rate is not None
    if capacity is None:
        own_cap = own_sieve.capacity if own_sieve is not None else None
        capacity = own_cap if own_cap is not None else 10_000
    if fp_rate is None:
        own_fp = own_sieve.fp_rate if own_sieve is not None else None
        fp_rate = own_fp if own_fp is not None else 0.01
    own_geom = _sieve_geometry(own_sieve)
    if explicit and own_geom is not None:
        n_bits, n_hashes = optimal_params(capacity, fp_rate)
        # BloomFilter pads n_bits up to a whole byte; compare what a filter
        # would actually be built with, not the raw formula output
        want = (n_bits + (-n_bits % 8), n_hashes)
        if want != own_geom:
            raise ValueError(
                "cannot merge BloomFilters with mismatched parameters: "
                f"requested capacity={capacity}, fp_rate={fp_rate} derives "
                f"(n_bits={want[0]}, n_hashes={want[1]}) but the selector's "
                f"installed sieve was built with (n_bits={own_geom[0]}, "
                f"n_hashes={own_geom[1]})"
            )
    if sieves:
        first = _sieve_geometry(sieves[0])
        for i, s in enumerate(sieves[1:], start=1):
            geom = _sieve_geometry(s)
            if geom != first:
                raise ValueError(
                    "cannot merge BloomFilters with mismatched parameters: "
                    f"sieve 0 was built with (n_bits, n_hashes) = {first} "
                    f"but sieve {i} with {geom}"
                )

    base = (
        selector.db
        if selector.db is not None
        else TuningDatabase(arch=selector.arch)
    )
    merged_report = MergeReport()
    if dbs:
        _, r = merge_databases(list(dbs), into=base)
        merged_report = merged_report.combine(r)
    if journals:
        _, r = merge_journal_shards(list(journals), into=base, missing_ok=missing_ok)
        merged_report = merged_report.combine(r)
    merged_report.merged = base.n_records()

    generation = selector.sieve_generation
    if sieves:
        generation = max(generation, *(s.generation for s in sieves))
    generation += 1
    if sieves:
        sieve = merge_sieves(list(sieves), generation=generation)
        # winners the sibling sieves never encoded (e.g. records that only
        # travelled as journal shards) still need to be queryable — each
        # class inserts under its own key encoding
        sieve.build_from_winners(base.winners(), arch=base.arch)
        for cls_name, recs in base.xarch.items():
            sieve.build_from_winners(
                {key: policy_from_name(r.policy) for key, r in recs.items()},
                arch=cls_name,
            )
    else:
        sieve = base.build_sieve(
            capacity=capacity, fp_rate=fp_rate, generation=generation
        )
    calibration = (
        base.calibration if base.calibration is not None else selector.calibration
    )
    state = SelectorState(
        db=base,
        sieve=sieve,
        calibration=calibration,
        arch=selector.arch,
        report=merged_report,
    )
    selector.hot_swap(state=state, keys=None)
    log.info(
        "federated merge: %d sources, %d records examined -> %d merged "
        "(%d conflicts, %d superseded, %d load errors), sieve generation %d",
        merged_report.sources,
        merged_report.examined,
        merged_report.merged,
        merged_report.conflicts,
        merged_report.superseded,
        merged_report.load_errors,
        generation,
    )
    return state


def selection_table(
    selector: KernelSelector, keys: Iterable[OpKey]
) -> Dict[OpKey, Tuple[str, str, int]]:
    """(policy, cfg, g) the selector's database resolves for each key —
    the equivalence surface federated tests/benchmarks compare between a
    merged fleet and a single-worker full sweep."""
    out: Dict[OpKey, Tuple[str, str, int]] = {}
    for key in keys:
        rec = selector.db.records.get(key) if selector.db is not None else None
        if rec is not None:
            out[key] = (rec.policy, rec.cfg, rec.g)
    return out
