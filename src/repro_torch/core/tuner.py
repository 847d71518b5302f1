"""The dispatch half of the tuning database (the port's part of
``repro.core.tuner``): :class:`TuningRecord` and the in-memory
:class:`TuningDatabase` the selector reads — records per arch class, foreign
classes kept apart as ``xarch`` warm seeds, and the Open-sieve build. The
snapshot and journal codecs, calibration and the ``Tuner`` sweep stay in the
JAX package until the port's tuning slice lands.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.arch import DEFAULT_ARCH
from repro_torch.core.op import OpKey
from repro_torch.core.opensieve import OpenSieve
from repro_torch.core.policies import ALL_POLICIES, Policy, policy_from_name

#: grid size every record/journal line implied before ``g`` was swept —
#: the old kernels launched with g=8 unconditionally.
LEGACY_GRID = 8


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



@dataclass
class TuningDatabase:
    """Keyed store of tuned winners + per-policy sweep results, with
    federation stamps (persistence arrives with the port's tuning slice).

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
    #: architecture class this database's OWN records were measured on;
    #: anything stamped with a different class routes to ``xarch``.
    arch: str = DEFAULT_ARCH
    #: foreign-class records: class string -> {key -> record}. Never direct
    #: dispatch hits — the selector re-ranks their policies under the local
    #: machine (the ``"xarch"`` source).
    xarch: Dict[str, Dict[OpKey, TuningRecord]] = field(default_factory=dict)

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
