"""Online adaptation: miss-driven autotuning in the serving path (the port's
copy of ``repro.core.adaptive``).

The offline :class:`~repro_torch.core.tuner.Tuner` covers the problem sizes someone
thought to sweep ahead of time; any :class:`~repro_torch.core.op.GemmOp`
fingerprint outside that set (a new model config, a new dtype/epilogue combo,
a resharded MoE group size) falls through to the heuristic forever. The
:class:`AdaptiveTuner` closes that gap at runtime:

  1. it registers as the :class:`~repro_torch.core.selector.KernelSelector` miss
     hook, so every dispatch that did NOT resolve from the tuning database
     increments a bounded miss-frequency table keyed on the op fingerprint;
  2. fingerprints whose miss count crosses ``hot_threshold`` are promoted to
     a FIFO of *hot* tuning candidates;
  3. :meth:`AdaptiveTuner.adapt` — called from the serving loop between
     decode steps (``ServeEngine(adapt_every=...)``) — sweeps
     (policy, tile, grid-size) candidates at the fingerprint's real operand
     byte-widths for a few hot fingerprints under an optional wallclock
     budget and commits each winner as an incremental
     :class:`~repro_torch.core.tuner.TuningRecord`;
  4. commits append to the shared JSONL journal (restart-safe warm start),
     invalidate the selector's memoised pick for that key, and — every
     ``rebuild_every`` commits — rebuild the Bloom sieve from the grown
     database under the next *generation* and hot-swap it in (Bloom filters
     cannot delete, so adaptation never mutates a live sieve).

Measurement is injected via the ``Tuner``: the default analytical cost model
works anywhere; pass ``Tuner(measure_fn=measure_wallclock(...))`` to time
the hand-written kernels on the card, bounded by ``budget_s`` per adaptation
round so tuning never starves the decode loop.

Misses count per *dispatch* here, not per trace: the JAX package's selector
runs at jit trace time, so a jit-cached repeat never re-notifies, while the
port's eager engine calls the selector (and so the miss hook) at every
dispatch. A fingerprint therefore crosses ``hot_threshold`` after that many
dispatches. The code is the JAX package's; at ``hot_threshold=1`` both
promote the same set of fingerprints.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Dict, List, Optional

from repro_torch.core.op import GemmOp, OpKey
from repro_torch.core.selector import KernelSelector, Selection
from repro_torch.core.tuner import Tuner, TuningDatabase, append_journal


@dataclass(frozen=True)
class AdaptiveConfig:
    """Knobs of the online adaptation loop (thresholds, bounds, budget)."""

    #: misses before a fingerprint is promoted to a tuning candidate
    hot_threshold: int = 3
    #: bound on the miss-frequency table (coldest entries evicted first)
    max_pending: int = 256
    #: hot fingerprints tuned per ``adapt()`` round (keeps rounds short)
    max_tunes_per_step: int = 4
    #: commits between generational sieve rebuilds
    rebuild_every: int = 8
    #: wallclock budget (seconds) per ``adapt()`` round; ``None`` = no cap.
    #: Matters when measurement is real hardware timing rather than the
    #: analytical model — adaptation must never starve the decode loop.
    budget_s: Optional[float] = None
    #: parameters for rebuilt sieves
    sieve_capacity: int = 10_000
    sieve_fp_rate: float = 0.01
    #: budgeted adaptation sweeps: measure only the cost model's top-k
    #: ranked candidates per hot fingerprint (see ``Tuner(top_k=...)``)
    #: instead of the exhaustive (policy x cfg x grid) oracle sweep.
    #: ``None`` keeps the full sweep. Only applies to the default-built
    #: Tuner — an explicitly passed ``tuner`` keeps its own budget.
    top_k: Optional[int] = None


@dataclass
class AdaptiveStats:
    """Lifetime counters of one :class:`AdaptiveTuner` (observability)."""

    misses: int = 0  # miss-hook notifications observed
    promoted: int = 0  # fingerprints that crossed hot_threshold
    evicted: int = 0  # cold fingerprints dropped by the bound
    adaptations: int = 0  # TuningRecords committed to the database
    rebuilds: int = 0  # generational sieve rebuilds + hot-swaps
    budget_stops: int = 0  # adapt() rounds cut short by budget_s


class AdaptiveTuner:
    """Watches a selector's misses and tunes the hottest fingerprints online.

    The tuner owns (or adopts) the selector's :class:`TuningDatabase`;
    committed records are immediately visible to the selector (exact-key DB
    hit), journal-persisted when ``journal`` is set, and folded into the
    Bloom sieve on the next generational rebuild.
    """

    def __init__(
        self,
        selector: KernelSelector,
        db: Optional[TuningDatabase] = None,
        tuner: Optional[Tuner] = None,
        config: Optional[AdaptiveConfig] = None,
        journal: Optional[str] = None,
    ):
        self.selector = selector
        self.db = (
            db
            if db is not None
            else (selector.db or TuningDatabase(arch=selector.arch))
        )
        if selector.db is not self.db:
            # the tuner owns the selector's database: commits must be the
            # records selection reads, so an explicitly passed db replaces
            # whatever the selector held (memoised picks dropped — they were
            # resolved against the old database)
            selector.hot_swap(state=replace(selector.state, db=self.db))
        self.cfg = config or AdaptiveConfig()
        self.tuner = tuner or Tuner(
            policies=selector.policies, tile_configs=selector.tile_configs,
            mach=selector.mach, grid_sizes=selector.grid_sizes,
            top_k=self.cfg.top_k, calibration=selector.calibration,
            arch=selector.arch,
        )
        self.journal = journal
        self.stats = AdaptiveStats()
        self._miss_counts: Dict[OpKey, int] = {}
        self._miss_ops: Dict[OpKey, GemmOp] = {}
        self._hot: List[OpKey] = []  # FIFO of promoted, not-yet-tuned keys
        self._commits_since_rebuild = 0
        selector.on_miss = self.observe

    # -- miss ingestion (runs on every dispatch; must stay cheap) ----------
    def observe(self, op: GemmOp, sel: Selection) -> None:
        """Selector miss hook: one call per dispatch that did not resolve
        from the tuning database."""
        key = op.key
        if key in self.db.records:
            return  # tuned between memoisation and notification
        self.stats.misses += 1
        count = self._miss_counts.get(key, 0) + 1
        self._miss_counts[key] = count
        self._miss_ops.setdefault(key, op)
        if count == self.cfg.hot_threshold:
            self._hot.append(key)
            self.stats.promoted += 1
        self._evict_overflow()

    def _evict_overflow(self) -> None:
        # the hot queue is bounded too (at hot_threshold=1 every miss
        # promotes, so the miss-table bound alone would be inert): when it
        # overflows, the stalest promotion goes first — a fingerprint that
        # waited max_pending promotions without being tuned is cold traffic
        while len(self._hot) > self.cfg.max_pending:
            stale = self._hot.pop(0)
            self._forget(stale)
            self.stats.evicted += 1
        while len(self._miss_counts) > self.cfg.max_pending + len(self._hot):
            coldest = None
            for key, count in self._miss_counts.items():
                if count >= self.cfg.hot_threshold:
                    continue  # promoted entries evict only via the hot bound
                if coldest is None or count < self._miss_counts[coldest]:
                    coldest = key
            if coldest is None:
                return
            self._forget(coldest)
            self.stats.evicted += 1

    def _forget(self, key: OpKey) -> None:
        self._miss_counts.pop(key, None)
        self._miss_ops.pop(key, None)

    # -- introspection ------------------------------------------------------
    @property
    def pending_hot(self) -> int:
        """Promoted fingerprints waiting for an adaptation round."""
        return len(self._hot)

    @property
    def tracked(self) -> int:
        """Distinct untuned fingerprints currently in the miss table."""
        return len(self._miss_counts)

    # -- adaptation rounds ---------------------------------------------------
    def adapt(self, budget_s: Optional[float] = None) -> int:
        """One adaptation round: tune up to ``max_tunes_per_step`` hot
        fingerprints (oldest promotion first) within the wallclock budget,
        commit the winners, and rebuild the sieve generation when due.
        Returns the number of records committed this round."""
        budget = budget_s if budget_s is not None else self.cfg.budget_s
        deadline = None if budget is None else time.perf_counter() + budget
        committed = 0
        while self._hot and committed < self.cfg.max_tunes_per_step:
            if deadline is not None and time.perf_counter() >= deadline:
                self.stats.budget_stops += 1
                break
            key = self._hot.pop(0)
            op = self._miss_ops.get(key)
            if op is None or key in self.db.records:
                self._forget(key)
                continue
            self._commit(op)
            committed += 1
        if self._commits_since_rebuild >= self.cfg.rebuild_every:
            self.rebuild_sieve()
        return committed

    def _commit(self, op: GemmOp) -> None:
        rec, per_policy = self.tuner.tune_size(op)
        self.db.add_record(rec, per_policy)
        if self.journal is not None:
            append_journal(self.journal, rec, per_policy)
        # drop the stale memoised sieve/fallback pick so the very next
        # dispatch of this fingerprint resolves from the database
        self.selector.hot_swap(keys=[rec.size])
        self._forget(rec.size)
        self.stats.adaptations += 1
        self._commits_since_rebuild += 1

    def drain(self, budget_s: Optional[float] = None) -> int:
        """Tune every pending hot fingerprint (end-of-run flush), then fold
        any un-sieved commits into a final generational rebuild."""
        total = 0
        while self._hot:
            n = self.adapt(budget_s=budget_s)
            if n == 0:
                break  # budget exhausted or nothing tunable
            total += n
        if self._commits_since_rebuild:
            self.rebuild_sieve()
        return total

    def rebuild_sieve(self) -> int:
        """Build a fresh sieve from the grown database under the next
        generation and hot-swap it into the selector (old sieve serves until
        the atomic swap; memoised non-tuned picks are dropped so no stale
        eliminated candidate survives the generation bump). Returns the new
        generation number."""
        generation = self.selector.sieve_generation + 1
        sieve = self.db.build_sieve(
            capacity=self.cfg.sieve_capacity,
            fp_rate=self.cfg.sieve_fp_rate,
            generation=generation,
        )
        # full cache invalidation: sieve/fallback picks memoised under the
        # old generation must not survive it, and tuned picks re-resolve
        # from the database for the cost of one dict hit
        self.selector.hot_swap(state=replace(self.selector.state, sieve=sieve), keys=None)
        self.stats.rebuilds += 1
        self._commits_since_rebuild = 0
        return generation
