"""Streaming journal gossip: continuous cross-worker tuning exchange (the
port's copy of ``repro.core.gossip``).

Federation (:mod:`repro_torch.core.federate`) is a batch operation — a worker
folds the fleet's artifacts in once, typically at startup. A long-running
fleet keeps learning *after* that point: every worker's
:class:`~repro_torch.core.adaptive.AdaptiveTuner` appends fresh commits to its own
journal shard, and without a live exchange those commits only reach
siblings on the next restart. This module closes the loop:

  * :class:`JournalTail` reads one sibling's shard *incrementally* — it
    remembers a byte offset and only parses lines appended since the last
    poll. A torn final line (a producer crashed or is mid-``append_journal``
    — possibly mid-multi-byte-UTF-8-sequence, which is why the tail reads
    bytes and splits on newlines before decoding) is NOT consumed: the
    offset stays put so the completed line is read whole on the next poll,
    exactly mirroring ``replay_journal``'s crash tolerance. Complete but
    malformed lines are skipped and counted, and a shard that shrank
    (rotation/truncation) restarts from byte 0.
  * :class:`GossipExchange` folds every tail's new entries into the live
    selector: entries stage into a scratch database through the same tagged
    registry ``replay_journal`` uses (:func:`repro_torch.core.tuner.apply_journal_entry`
    — unknown future tags skip-and-count), merge under per-arch-class
    last-writer-wins (a local commit newer than a sibling's stands), and
    land via one atomic ``hot_swap(state=...)`` with a generation-bumped
    sieve. Same-class sibling commits become direct database hits on the
    very next dispatch; other-class commits surface as ``"xarch"`` warm
    seeds — so a gossiping fleet converges to zero cross-worker misses with
    no restart anywhere.

Wire it into serving with ``--gossip-every N`` (``repro_torch.launch.serve``): every
N engine steps each worker polls its siblings' shards. Polling an
append-only file is deliberately humble infrastructure — no broker, no
sockets — matching the journal's crash-tolerance story: the file IS the
protocol.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from repro_torch.core.federate import merge_databases
from repro_torch.core.selector import KernelSelector, SelectorState
from repro_torch.core.tuner import TuningDatabase, apply_journal_entry
from repro_torch.utils.logging import get_logger

log = get_logger("gossip")


@dataclass
class GossipStats:
    """Lifetime counters of one :class:`GossipExchange` (observability)."""

    rounds: int = 0  # exchange() calls
    polls: int = 0  # individual shard polls across rounds
    entries: int = 0  # journal entries applied from siblings
    swaps: int = 0  # hot_swaps installed (rounds that found news)
    load_errors: int = 0  # malformed lines + unknown-tag skips observed


class JournalTail:
    """Incremental reader over one append-only JSONL journal shard.

    ``poll()`` returns the decoded entries appended since the previous
    poll, advancing a byte offset past exactly the lines it consumed. The
    final line is only consumed when newline-terminated: a torn tail (torn
    anywhere, including inside a multi-byte UTF-8 sequence) stays
    unconsumed so the next poll — after the producer finishes the append —
    reads it complete. A complete line that fails to decode is counted in
    ``load_errors`` and skipped permanently (it will never repair itself).
    """

    def __init__(self, path: str, missing_ok: bool = True):
        self.path = path
        self.missing_ok = missing_ok
        self.offset = 0
        self.load_errors = 0

    def poll(self) -> List[dict]:
        """Decode every complete line appended since the last poll."""
        try:
            f = open(self.path, "rb")
        except FileNotFoundError:
            if self.missing_ok:
                return []  # shard not created yet: nothing new
            raise
        with f:
            size = f.seek(0, os.SEEK_END)
            if size < self.offset:
                # the shard shrank (rotated or truncated): our offset points
                # past the end, so the only safe resume is a full re-read
                log.warning(
                    "%s shrank below the tail offset (%d < %d); re-reading",
                    self.path,
                    size,
                    self.offset,
                )
                self.offset = 0
            f.seek(self.offset)
            buf = f.read()
        out: List[dict] = []
        consumed = 0
        while True:
            nl = buf.find(b"\n", consumed)
            if nl < 0:
                break  # torn/in-progress tail: leave it for the next poll
            raw = buf[consumed:nl]
            consumed = nl + 1
            if not raw.strip():
                continue
            try:
                out.append(json.loads(raw.decode("utf-8")))
            except ValueError as e:
                # complete but malformed — unlike a torn tail this can never
                # heal, so it is consumed (offset moves past it) and counted
                self.load_errors += 1
                log.warning("%s: skipping malformed journal line: %s", self.path, e)
        self.offset += consumed
        return out


class GossipExchange:
    """Periodically folds sibling journal shards into a live selector.

    One instance per worker: ``peers`` are the *other* workers' shard
    paths (a worker must not gossip its own shard — its commits are already
    in its database, and re-applying stamped copies is wasted work).
    ``exchange()`` is cheap when nothing changed: N ``seek``/``read`` calls
    finding zero new bytes install nothing.
    """

    def __init__(
        self,
        selector: KernelSelector,
        peers: Sequence[str],
        missing_ok: bool = True,
        sieve_capacity: Optional[int] = None,
        sieve_fp_rate: Optional[float] = None,
    ):
        self.selector = selector
        self.tails = [JournalTail(p, missing_ok=missing_ok) for p in peers]
        self.sieve_capacity = sieve_capacity
        self.sieve_fp_rate = sieve_fp_rate
        self.stats = GossipStats()

    def _stage(self) -> Optional[TuningDatabase]:
        """Poll every tail into one staging database (None when no news).

        Staging adopts the selector's arch class, so a sibling's stamped
        records route exactly as a direct replay would: same class into
        ``records``, foreign classes into ``xarch``. Unknown-tag entries
        (future producers) skip-and-count, mirroring ``replay_journal``."""
        staged: Optional[TuningDatabase] = None
        for tail in self.tails:
            self.stats.polls += 1
            before = tail.load_errors
            for entry in tail.poll():
                if staged is None:
                    staged = TuningDatabase(arch=self.selector.arch)
                try:
                    if apply_journal_entry(staged, entry):
                        self.stats.entries += 1
                    else:
                        staged.load_errors += 1  # unknown tag: forward compat
                        self.stats.load_errors += 1
                except (ValueError, IndexError, TypeError, KeyError) as e:
                    staged.load_errors += 1
                    self.stats.load_errors += 1
                    log.warning(
                        "%s: skipping malformed journal entry: %s", tail.path, e
                    )
            self.stats.load_errors += tail.load_errors - before
        return staged

    def exchange(self) -> int:
        """One gossip round. Returns the number of sibling entries applied.

        New entries merge into the selector's database under per-class
        last-writer-wins (``merge_databases`` — a local commit newer than a
        sibling's copy stands), the sieve rebuilds one generation up with
        the worker's installed geometry, and everything lands in one atomic
        ``hot_swap(state=...)``. No news -> no swap: memoised picks survive
        quiet rounds untouched."""
        self.stats.rounds += 1
        staged = self._stage()
        if staged is None or (
            staged.n_records() == 0
            and staged.calibration is None
            and not staged.xarch_calibrations
            and not staged.arch_profiles
        ):
            return 0
        sel = self.selector
        base = sel.db if sel.db is not None else TuningDatabase(arch=sel.arch)
        merge_databases([staged], into=base)
        capacity = self.sieve_capacity
        if capacity is None:
            capacity = getattr(sel.sieve, "capacity", None) or 10_000
        fp_rate = self.sieve_fp_rate
        if fp_rate is None:
            fp_rate = getattr(sel.sieve, "fp_rate", None) or 0.01
        sieve = base.build_sieve(
            capacity=capacity,
            fp_rate=fp_rate,
            generation=sel.sieve_generation + 1,
        )
        calibration = (
            base.calibration if base.calibration is not None else sel.calibration
        )
        sel.hot_swap(
            state=SelectorState(
                db=base, sieve=sieve, calibration=calibration, arch=sel.arch
            ),
            keys=None,
        )
        self.stats.swaps += 1
        applied = staged.n_records()
        log.info(
            "gossip round %d: %d sibling records folded in, sieve generation %d",
            self.stats.rounds,
            applied,
            sieve.generation,
        )
        return applied
