"""Runtime kernel selection: Open-sieve query -> candidate policies -> pick
(the port's copy of ``repro.core.selector``). Artifacts — the tuning
database, the sieve, a calibration and the arch class — install only through
one :class:`SelectorState` (the JAX package's deprecated
``db=/sieve=/calibration=`` keywords are not ported); :meth:`hot_swap`
replaces them mid-stream, and the ``on_miss`` hook feeds online adaptation
(:mod:`repro_torch.core.adaptive`). :func:`default_selector` scores under
the nominal H100 and the Hopper tile set on a CUDA device.

Dispatch path for a :class:`repro.core.op.GemmOp` (selection keys on the op
fingerprint — per-shard local shape, group count, dtypes, epilogue):
  1. Exact tuning-database hit -> return the tuned (policy, config, g).
     Only records of the selector's OWN arch class qualify: a record tuned
     on a different machine class (:mod:`repro_torch.core.arch`) instead supplies
     its winner/runner-up policies as a *warm seed*, re-ranked by the cost
     model under the local (calibrated) machine — the ``"xarch"`` source,
     which still counts as a miss for online adaptation so local
     measurements eventually supersede the import.
  2. Otherwise query the Bloom filters. Policies answering "definitely
     absent" are pruned (the paper's headline: up to ~95.8% of evaluations
     skipped, 100% true-negative rate). Surviving candidates are scored with
     the fast analytical model — at the op's *actual* operand byte-widths,
     jointly over the swept grid sizes — and the best wins.
  3. If every filter says absent (a size the tuner never saw and no filter
     aliases): with a :class:`~repro_torch.core.calibrate.CalibratedMachine`
     installed, dispatch from the calibrated model's argmin over ALL
     policies (the ``"model"`` analytical-first warm start — still reported
     to the miss hook, so online adaptation measures hot shapes and
     promotes them to real database records); otherwise fall back to the
     naive single-policy default the original Stream-K paper proposes —
     data-parallel — scored against ALL_SK for safety.

Plain 2-D ops key as the legacy ``(M, N, K)`` tuple, so tuning databases and
sieves built from bare problem sizes keep working; grouped / epilogue-fused
ops key (and therefore tune and prune) independently.

Selection runs on the host at every dispatch (PyTorch is eager) and is
memoised per op key — so the miss hook fires per *dispatch*, where the JAX
package's fires per jit trace; the recorded ``SelectionLog`` is how tests and
benchmarks introspect dispatch decisions. ``SelectorStats`` counts every
dispatch exactly once (cold source, cache hit, or forced), and memoised
repeats re-credit their evals/pruned, so ``elimination_rate`` is weighted by
what the workload actually dispatched — not just by unique shapes.

Elimination accounting is honest about *who* did the eliminating: only
dispatches that actually consulted the Bloom filters credit ``pruned``. A
tuned database hit skips the filters entirely — it contributes zero evals
AND zero pruned, so a warm database drives ``elimination_rate`` toward the
sieve's true contribution instead of inflating the paper-headline metric.
Fully forced overrides perform no selection work and leave the rate
untouched.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core import costmodel
from repro_torch.core.arch import DEFAULT_ARCH
from repro_torch.core.costmodel import DtypeBytes
from repro_torch.core.op import GemmOp, OpKey
from repro_torch.core.opensieve import OpenSieve
from repro_torch.core.policies import (
    ALL_POLICIES,
    ALL_SK,
    DEFAULT_TILE_CONFIGS,
    DP,
    HOPPER_TILE_CONFIGS,
    Policy,
    TileConfig,
    policy_from_name,
)
from repro_torch.core.tuner import LEGACY_GRID, TuningDatabase
from repro_torch.core.workpart import GemmShape

MNK = Tuple[int, int, int]


@dataclass(frozen=True)
class Selection:
    """One (policy, tile config, grid size) pick plus its provenance."""

    policy: Policy
    cfg: TileConfig
    source: str  # "tuned" | "xarch" | "sieve" | "model" | "fallback" | "forced"
    evals: int  # how many (policy) evaluations the scorer performed
    pruned: int  # how many the Bloom filters eliminated
    #: grid size the kernel launches with (tuned winner's g, or the scored
    #: best over the selector's grid sweep; LEGACY_GRID when nothing chose)
    g: int = LEGACY_GRID


@dataclass
class SelectorStats:
    """Per-selector lookup/eval counters (the paper's accounting unit)."""

    lookups: int = 0
    tuned_hits: int = 0
    #: dispatches seeded by a foreign arch class's record — its winner /
    #: runner-up policies re-ranked under the LOCAL machine (never applied
    #: verbatim); still a miss for online adaptation
    xarch_seeds: int = 0
    sieve_hits: int = 0
    #: unseen fingerprints dispatched from the calibrated model's argmin —
    #: the analytical-first warm start (still misses for online adaptation)
    model_warm: int = 0
    fallbacks: int = 0
    cache_hits: int = 0  # memoised repeats of an already-selected op
    forced: int = 0  # caller-supplied (policy, cfg) overrides
    evals: int = 0
    pruned: int = 0  # policies genuinely eliminated by Bloom filters

    @property
    def elimination_rate(self) -> float:
        """Fraction of filter-consulted policy evaluations the sieve skipped.
        Tuned hits bypass the filters and contribute to neither term, so a
        warm database cannot inflate the sieve's paper-headline metric."""
        tot = self.evals + self.pruned
        return self.pruned / tot if tot else 0.0


_CFG_BY_NAME = {c.name: c for c in DEFAULT_TILE_CONFIGS + HOPPER_TILE_CONFIGS}


def _cfg_from_name(name: str) -> TileConfig:
    if name in _CFG_BY_NAME:
        return _CFG_BY_NAME[name]
    bm, bn, bk = (int(x) for x in name.split("x"))
    return TileConfig(bm, bn, bk)


#: Miss-hook signature: called once per dispatch whose (memoised) selection
#: did NOT come from the tuning database — the signal online adaptation
#: feeds on. Must be cheap; it runs on every dispatch.
MissHook = Callable[[GemmOp, Selection], None]


@dataclass(frozen=True)
class SelectorState:
    """One atomic snapshot of a selector's installed tuning artifacts.

    The database, sieve, calibration and arch class travel as a single
    frozen value: ``KernelSelector(state=...)`` and ``hot_swap(state=...)``
    install all four in one reference assignment, so a database from one
    generation is never paired with a sieve from another."""

    db: Optional[TuningDatabase] = None
    sieve: Optional[OpenSieve] = None
    #: installed CalibratedMachine (or None): when set, all cost-model
    #: scoring runs under the fitted per-dtype-profile machine, and unseen
    #: fingerprints dispatch via the "model" source instead of the fallback
    calibration: object = None
    #: the selector's own arch class (:mod:`repro_torch.core.arch`) — the class
    #: whose records qualify as direct database hits; every other class is
    #: an ``"xarch"`` warm seed
    arch: str = DEFAULT_ARCH
    #: provenance of the install (e.g. the MergeReport behind a federation
    #: round). Excluded from equality — identical artifacts compare equal
    #: whatever produced them. Unknown attribute reads delegate here, so
    #: ``federate_selector``'s result reads ``.merged`` / ``.conflicts``.
    report: object = field(default=None, compare=False)

    def __getattr__(self, name: str):
        report = object.__getattribute__(self, "report")
        if report is not None:
            return getattr(report, name)
        raise AttributeError(f"{type(self).__name__} has no attribute {name!r}")


class KernelSelector:
    """The paper's selection pipeline, memoised per op key: tuned-database
    exact hit (own arch class) -> cross-arch warm seeds -> Bloom-sieve
    candidate pruning + cost-model scoring -> unsieved cost-model fallback.

    Tuning artifacts live in one frozen :class:`SelectorState`
    (``self.state``); the ``db``/``sieve``/``calibration``/``arch``
    properties read through to it. Install new artifacts atomically with
    :meth:`hot_swap`."""

    def __init__(
        self,
        mach: costmodel.Machine = costmodel.V5E,
        policies: Sequence[Policy] = ALL_POLICIES,
        tile_configs: Sequence[TileConfig] = DEFAULT_TILE_CONFIGS,
        grid_sizes: Optional[Sequence[int]] = None,
        state: Optional[SelectorState] = None,
        on_miss: Optional[MissHook] = None,
    ):
        self._state = state if state is not None else SelectorState()
        self.mach = mach
        self.policies = tuple(policies)
        self.tile_configs = tuple(tile_configs)
        self.on_miss = on_miss
        self.grid_sizes = (
            tuple(grid_sizes)
            if grid_sizes is not None
            else costmodel.default_grid_sizes(mach)
        )
        self.stats = SelectorStats()
        self._cache: Dict[OpKey, Selection] = {}

    # -- state ---------------------------------------------------------------
    @property
    def state(self) -> SelectorState:
        """The installed artifact snapshot (frozen; swap via hot_swap)."""
        return self._state

    @property
    def db(self) -> Optional[TuningDatabase]:
        """Installed tuning database (read-only view into ``state``)."""
        return self._state.db

    @property
    def sieve(self) -> Optional[OpenSieve]:
        """Installed Open-sieve (read-only view into ``state``)."""
        return self._state.sieve

    @property
    def calibration(self):
        """Installed CalibratedMachine or None (view into ``state``)."""
        return self._state.calibration

    @property
    def arch(self) -> str:
        """This selector's arch class (view into ``state``)."""
        return self._state.arch

    @property
    def sieve_generation(self) -> int:
        """Build version of the currently installed sieve (0 when none)."""
        return self.sieve.generation if self.sieve is not None else 0

    def _notify_miss(self, op: GemmOp, sel: Selection) -> None:
        if self.on_miss is not None and sel.source != "tuned":
            self.on_miss(op, sel)

    # -- online adaptation --------------------------------------------------
    def hot_swap(
        self,
        state: Optional[SelectorState] = None,
        keys: Optional[Iterable[OpKey]] = None,
    ) -> int:
        """Install updated tuning artifacts mid-stream.

        ``state`` (None: keep the installed one) swaps database, sieve,
        calibration and arch class together in one reference assignment.
        Memoised selections for ``keys`` (all keys when ``None``) are
        dropped so the next dispatch of a freshly tuned fingerprint
        re-resolves against the new artifacts instead of replaying a stale
        sieve/fallback pick. Installing a different calibration drops the
        memo wholesale regardless of ``keys``: the (frozen, hashable)
        machines inside it key every scoring cache, and new constants
        re-score EVERY non-tuned pick. Returns the number of cache entries
        invalidated."""
        if state is not None:
            if state.calibration is not self._state.calibration:
                keys = None
            self._state = state
        if keys is None:
            n = len(self._cache)
            self._cache.clear()
            return n
        return sum(1 for k in keys if self._cache.pop(k, None) is not None)

    # -- scoring -----------------------------------------------------------
    def scoring_machine(self, dt: DtypeBytes) -> costmodel.Machine:
        """Machine the cost model scores under for a byte-width profile:
        the installed calibration's per-profile fit, else the nominal
        machine. Frozen/hashable either way — it participates in every
        scoring-cache key."""
        if self.calibration is not None:
            return self.calibration.machine_for(dt)
        return self.mach

    def _score(
        self, size: MNK, pols: Sequence[Policy], dt: DtypeBytes
    ) -> Tuple[Policy, TileConfig, int, int]:
        """Best (policy, cfg, g) over the candidate policies — the argmin of
        :func:`costmodel.rank_candidates` at the op's real byte-widths,
        under the (possibly calibrated) scoring machine. ``evals`` counts
        *policies* scored (the unit Bloom pruning removes), whatever the
        width of the inner cfg x g sweep. ``size`` is a bare local (M, N, K)
        or an already-built shape (e.g. the GroupedGemmShape of a fused
        grouped op, whose concatenated tile space the model scores)."""
        shape = size if isinstance(size, GemmShape) else GemmShape(*size)
        pol, cfg, g, _ = costmodel.rank_candidates(
            shape,
            self.scoring_machine(dt),
            tuple(pols),
            self.tile_configs,
            self.grid_sizes,
            dt,
        )[0]
        return pol, cfg, g, len(pols)

    def _db_record(self, op: GemmOp):
        """Exact op-key hit first; shape-only ops of any dtype then fall
        back to the dtype-agnostic legacy (M, N, K) record (the paper's
        databases carry no dtype — a bf16 model must still benefit from
        artifacts tuned on bare sizes)."""
        if self.db is None:
            return None
        rec = self.db.records.get(op.key)
        if rec is None and op.mnk_compatible:
            rec = self.db.records.get(op.local)
        return rec

    def _xarch_policies(self, op: GemmOp) -> List[Policy]:
        """Warm-seed candidates from foreign-class records of this
        fingerprint: the winner (and distinct runner-up) policies every
        other arch class measured for the key. Never dispatched verbatim —
        the caller re-ranks them under the LOCAL (calibrated) machine, so a
        sibling generation's pick is advice, not an answer. Classes iterate
        in sorted order, keeping the seed set deterministic across fleets."""
        if self.db is None:
            return []
        recs = self.db.xarch_records_for(op.key)
        if not recs and op.mnk_compatible and op.key != op.local:
            recs = self.db.xarch_records_for(op.local)
        pols: List[Policy] = []
        for _cls, rec in recs:
            for name in (rec.policy, rec.runner_up_policy):
                if not name:
                    continue
                try:
                    pol = policy_from_name(name)
                except (KeyError, ValueError):
                    continue  # policy registry drift across producers
                if pol not in pols:
                    pols.append(pol)
        return pols

    def _sieve_candidates(self, op: GemmOp):
        if op.mnk_compatible and op.key != op.local:
            return self.sieve.candidates_any(op.key, op.local, arch=self.arch)
        return self.sieve.candidates(op.key, arch=self.arch)

    def _lookup(self, op: GemmOp) -> Tuple[Selection, bool]:
        """Memoised selection for an op; returns (selection, was_cached).
        No stats bookkeeping — callers categorise exactly once."""
        key = op.key
        if key in self._cache:
            return self._cache[key], True

        size = costmodel.op_shape(op)
        dt = costmodel.op_dtypes(op)
        sel: Selection
        rec = self._db_record(op)
        xpols = self._xarch_policies(op) if rec is None else []
        if rec is not None:
            # No filter was consulted: zero evals, zero pruned — a tuned hit
            # must not inflate the sieve's elimination rate.
            sel = Selection(
                policy=policy_from_name(rec.policy),
                cfg=_cfg_from_name(rec.cfg),
                source="tuned",
                evals=0,
                pruned=0,
                g=rec.g,
            )
        elif xpols:
            # A different arch class tuned this fingerprint: its winner /
            # runner-up policies seed the candidate set, re-ranked under the
            # local machine (no filter consulted — zero pruned). Still a
            # miss for adaptation: the seed serves until a local round
            # measures the shape and supersedes it with a real record.
            pol, cfg, g, evals = self._score(size, xpols, dt)
            sel = Selection(pol, cfg, "xarch", evals, 0, g=g)
        elif self.sieve is not None:
            cands = self._sieve_candidates(op)
            pruned = len(self.policies) - len(cands)
            if cands:
                pol, cfg, g, evals = self._score(size, cands, dt)
                sel = Selection(pol, cfg, "sieve", evals, pruned, g=g)
            elif self.calibration is not None:
                # every filter said "definitely absent" — with a calibrated
                # model installed, the unseen fingerprint dispatches from
                # the model's argmin over ALL policies (analytical-first
                # warm start) instead of the naive DP-vs-SK fallback
                pol, cfg, g, evals = self._score(size, self.policies, dt)
                sel = Selection(pol, cfg, "model", evals, pruned, g=g)
            else:
                pol, cfg, g, evals = self._score(size, (DP, ALL_SK), dt)
                sel = Selection(pol, cfg, "fallback", evals, pruned, g=g)
        elif self.calibration is not None:
            pol, cfg, g, evals = self._score(size, self.policies, dt)
            sel = Selection(pol, cfg, "model", evals, 0, g=g)
        else:
            pol, cfg, g, evals = self._score(size, self.policies, dt)
            sel = Selection(pol, cfg, "fallback", evals, 0, g=g)
        self._cache[key] = sel
        return sel, False

    # -- public ------------------------------------------------------------
    def select_op(self, op: GemmOp) -> Selection:
        """Select (policy, tile config, grid size) for a full op fingerprint.

        Every dispatch contributes its (memoised) evals/pruned to ``stats``,
        so ``elimination_rate`` is workload-weighted — a hot op that was
        pruned once keeps crediting that pruning on every repeat, matching
        the paper's per-dispatch accounting. Exactly one category counter
        (tuned/sieve/fallback/cache_hit) is bumped per lookup."""
        self.stats.lookups += 1
        sel, cached = self._lookup(op)
        if cached:
            self.stats.cache_hits += 1
        elif sel.source == "tuned":
            self.stats.tuned_hits += 1
        elif sel.source == "xarch":
            self.stats.xarch_seeds += 1
        elif sel.source == "sieve":
            self.stats.sieve_hits += 1
        elif sel.source == "model":
            self.stats.model_warm += 1
        else:
            self.stats.fallbacks += 1
        self.stats.evals += sel.evals
        self.stats.pruned += sel.pruned
        self._notify_miss(op, sel)
        return sel

    def select(self, m: int, n: int, k: int) -> Selection:
        """Legacy 2-D entry point: select for a bare local (M, N, K)."""
        return self.select_op(GemmOp.plain(m, n, k))

    def select_partial(
        self,
        op: GemmOp,
        policy: Optional[Policy] = None,
        cfg: Optional[TileConfig] = None,
        g: Optional[int] = None,
    ) -> Selection:
        """Fill the missing parts of a caller override from normal selection.
        Categorised as one ``forced`` lookup (never double-counted under a
        second category); the underlying selection's evals/pruned still
        count, since the selector really did that work."""
        self.stats.lookups += 1
        self.stats.forced += 1
        base, _ = self._lookup(op)
        sel = Selection(
            policy if policy is not None else base.policy,
            cfg if cfg is not None else base.cfg,
            "forced",
            base.evals,
            base.pruned,
            g=g if g is not None else base.g,
        )
        self.stats.evals += sel.evals
        self.stats.pruned += sel.pruned
        self._notify_miss(op, base)
        return sel

    def record_forced(
        self,
        op: GemmOp,
        policy: Policy,
        cfg: TileConfig,
        g: int = LEGACY_GRID,
    ) -> Selection:
        """Account a fully caller-forced (policy, cfg, g) dispatch (tuner
        sweeps, tests). It performs no evaluations and prunes nothing, so it
        leaves ``elimination_rate`` untouched — but it is a real dispatch,
        visible as one ``forced`` lookup. Forced dispatches of *untuned*
        fingerprints still feed the miss hook: the caller knowing a config
        is exactly the traffic online adaptation wants to learn from."""
        self.stats.lookups += 1
        self.stats.forced += 1
        sel = Selection(policy, cfg, "forced", 0, 0, g=g)
        if self._db_record(op) is None:
            self._notify_miss(op, sel)
        return sel


def default_selector(device=None) -> KernelSelector:
    """Selector with no tuning artifacts: pure cost-model scoring over all
    policies (what the models and the serve engine use when no tuned
    database is supplied; ``launch/serve.py --db/--journal/--calibrate``
    builds a warm one). On a CUDA device it scores under the nominal
    :data:`~repro_torch.core.costmodel.H100` with the Hopper tile set (the
    TPU tiles overflow a block's shared memory); elsewhere it keeps the JAX
    package's V5E defaults, so CPU selections match ``repro`` exactly."""
    import torch

    if device is not None and torch.device(device).type == "cuda":
        return KernelSelector(mach=costmodel.H100, tile_configs=HOPPER_TILE_CONFIGS)
    return KernelSelector()
