"""Batched serving engine with slot-based continuous batching (counterpart of
the slot engine of ``repro.serve.engine``), for the dense and MoE LMs alike:
the model carries the difference.

``n_slots`` sequences share one stacked KV cache. New requests are admitted
into free slots between decode steps, so the decode GEMMs stay at a steady
M = n_slots — the skinny-M regime where the Stream-K++ policies matter most.
Sampling (greedy or temperature) runs on the host in numpy, as in ``repro``,
so both packages draw the same tokens from the same logits and seed.

On the card the engine serves through the ``cuda`` backend (the
hand-written kernels) and the device's default selector (nominal H100,
Hopper tiles) unless the caller names others. An
:class:`~repro_torch.core.adaptive.AdaptiveTuner` (``adaptive=``) rides the
decode loop: every ``adapt_every`` engine steps it gets one round to tune
the hottest untuned fingerprints the traffic produced, and ``run()`` drains
what is left at its end.
"""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.adaptive import AdaptiveTuner
from repro_torch.core.gemm import gemm_context
from repro_torch.core.selector import KernelSelector, SelectorStats, default_selector
from repro_torch.models.lm import resolve_device

log = logging.getLogger("repro_torch.serve")


@dataclass(frozen=True)
class DispatchStats:
    """Point-in-time view of the engine's dispatch health: the selector's
    counters plus the online-adaptation loop's. Selector fields
    (``tuned_hits``, ``lookups``, ...) are reachable directly via attribute
    delegation."""

    selector: SelectorStats
    misses: int  # untuned dispatches observed (adaptive) or cold non-DB hits
    adaptations: int  # tuning records committed online
    sieve_generation: int  # build version of the live sieve
    db_records: int  # tuning database size
    pending_hot: int  # promoted fingerprints awaiting an adaptation round
    #: unseen fingerprints served from the calibrated model's argmin (the
    #: "model" selection source)
    model_warm: int = 0
    #: dispatches seeded from a foreign arch class's record (the "xarch"
    #: selection source)
    xarch_seeds: int = 0

    def __getattr__(self, name):
        return getattr(self.selector, name)


@dataclass
class Request:
    """One generation request and the tokens it has produced."""

    uid: int
    prompt: np.ndarray  # (P,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False
    truncated: bool = False  # retired early (the paged engine's anti-deadlock)


@dataclass
class ServeConfig:
    """Slot count, cache length, end-of-sequence id and sampling seed."""

    n_slots: int = 8
    max_seq: int = 512
    eos: int = 0
    seed: int = 0


class EngineCore:
    """Shared substrate of the serving engines: the dispatch context
    (selector, backend, selection-log mirroring), the adaptive-tuner hooks,
    host sampling, request validation, the prefill/decode timers, and the
    run() drain loop. Subclasses implement :meth:`step` (one scheduling
    quantum) and :meth:`outstanding`."""

    def __init__(
        self,
        model,
        params,
        *,
        max_seq: int,
        seed: int = 0,
        div=None,
        selector: Optional[KernelSelector] = None,
        backend: Optional[str] = None,
        device=None,
        adaptive: Optional[AdaptiveTuner] = None,
        adapt_every: int = 0,
    ):
        self.model = model
        self.params = params
        self.device = resolve_device(device)
        self.div = div or {}
        # the tuner is bound to a selector: without an explicit one the
        # engine serves through the tuner's
        if adaptive is not None and selector is None:
            selector = adaptive.selector
        self.adaptive = adaptive
        self.adapt_every = adapt_every
        self._steps = 0
        self.selector = selector if selector is not None else default_selector(self.device)
        self.backend = backend or ("cuda" if self.device.type == "cuda" else "torch")
        self.selection_log: List = []
        self.rng = np.random.default_rng(seed)
        self._max_seq = max_seq
        self._queue: List[Request] = []
        self._uid = 0
        self.unfinished: List[Request] = []
        self.exhausted: bool = False
        #: host seconds spent in prefill / decode, and tokens each produced
        #: (synchronised with the device, so they are wall times of the work)
        self.timing = {"prefill_s": 0.0, "prefill_tokens": 0, "decode_s": 0.0,
                       "decode_steps": 0, "decode_tokens": 0}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _timer(self) -> float:
        self._sync()
        return time.perf_counter()

    @contextmanager
    def _dispatch_ctx(self):
        with gemm_context(
            selector=self.selector, backend=self.backend, device=self.device
        ) as ctx:
            try:
                yield
            finally:
                self.selection_log.extend(ctx.log)

    @property
    def selector_stats(self) -> SelectorStats:
        """Counters of the selector that served this engine's traffic."""
        return self.selector.stats

    @property
    def dispatch_stats(self) -> DispatchStats:
        """The selector's counters with the adaptation loop's beside them."""
        sel = self.selector
        ad = self.adaptive
        if ad is not None:
            misses = ad.stats.misses
            adaptations = ad.stats.adaptations
            pending = ad.pending_hot
            db_records = len(ad.db.records)
        else:
            # without an adaptive loop, "miss" degrades to the cold
            # non-database selections the selector itself counted
            misses = (sel.stats.sieve_hits + sel.stats.model_warm
                      + sel.stats.xarch_seeds + sel.stats.fallbacks)
            adaptations = pending = 0
            db_records = len(sel.db.records) if sel.db is not None else 0
        return DispatchStats(
            selector=sel.stats, misses=misses, adaptations=adaptations,
            sieve_generation=sel.sieve_generation, db_records=db_records,
            pending_hot=pending, model_warm=sel.stats.model_warm,
            xarch_seeds=sel.stats.xarch_seeds,
        )

    def _sample(self, logits: np.ndarray, temperature: float) -> int:
        if temperature <= 0.0:
            return int(np.argmax(logits))
        p = np.exp((logits - logits.max()) / temperature)
        p /= p.sum()
        return int(self.rng.choice(len(p), p=p))

    def _validate_prompt(self, prompt) -> np.ndarray:
        prompt = np.asarray(prompt, np.int32)
        if len(prompt) == 0:
            raise ValueError("empty prompt (0 tokens) cannot be served")
        if len(prompt) > self._max_seq:
            raise ValueError(f"prompt length {len(prompt)} exceeds max_seq {self._max_seq}")
        return prompt

    def _maybe_adapt(self):
        self._steps += 1
        if self.adaptive is not None and self.adapt_every > 0 and (
            self._steps % self.adapt_every == 0
        ):
            self.adaptive.adapt()

    def step(self) -> bool:  # pragma: no cover - abstract
        """One scheduling quantum; False when there was nothing to do."""
        raise NotImplementedError

    def outstanding(self) -> List[Request]:  # pragma: no cover - abstract
        """Requests still queued or resident."""
        raise NotImplementedError

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Drain queue + resident requests; returns the finished requests.
        When ``max_steps`` runs out first the remainder stays on the engine,
        flagged by ``exhausted`` and listed in ``unfinished``."""
        seen: Dict[int, Request] = {}
        for _ in range(max_steps):
            for r in list(self._queue) + self.outstanding():
                seen[r.uid] = r
            if not self.step():
                break
        if self.adaptive is not None and self.adapt_every > 0:
            # end-of-run flush: short traces must still commit what they
            # learned (and journal it) before the process goes away
            self.adaptive.drain()
        self.unfinished = self.outstanding()
        self.exhausted = bool(self.unfinished)
        if self.exhausted:
            log.warning(
                "run(max_steps=%d) exhausted with %d request(s) still queued/active",
                max_steps,
                len(self.unfinished),
            )
        return [r for r in seen.values() if r.done]


class ServeEngine(EngineCore):
    """Slot engine: ``n_slots`` sequences share one stacked KV cache out to
    ``max_seq``."""

    def __init__(
        self,
        model,
        params,
        cfg: ServeConfig,
        *,
        div=None,
        selector: Optional[KernelSelector] = None,
        backend: Optional[str] = None,
        device=None,
        adaptive: Optional[AdaptiveTuner] = None,
        adapt_every: int = 0,
    ):
        super().__init__(
            model,
            params,
            max_seq=cfg.max_seq,
            seed=cfg.seed,
            div=div,
            selector=selector,
            backend=backend,
            device=device,
            adaptive=adaptive,
            adapt_every=adapt_every,
        )
        self.cfg = cfg
        self.cache = model.init_cache(cfg.n_slots, cfg.max_seq, device=self.device)
        self.pos = np.zeros((cfg.n_slots,), np.int64)  # next write position
        self.slot_req: List[Optional[Request]] = [None] * cfg.n_slots

    def submit(self, prompt, max_new_tokens: int = 32, temperature: float = 0.0) -> int:
        """Queue a request; returns its uid."""
        prompt = self._validate_prompt(prompt)
        self._uid += 1
        self._queue.append(Request(self._uid, prompt, max_new_tokens, temperature))
        return self._uid

    def outstanding(self) -> List[Request]:
        """Requests still queued or resident."""
        return list(self._queue) + [r for r in self.slot_req if r is not None]

    def _admit(self):
        for slot in range(self.cfg.n_slots):
            # a request can finish at prefill and free its slot at once;
            # keep admitting into the same slot so the queue still drains
            while self.slot_req[slot] is None and self._queue:
                self._prefill_slot(slot, self._queue.pop(0))
            if not self._queue:
                break

    def prefill_logits(self, prompt) -> torch.Tensor:
        """Last-position logits (1, 1, V) of one prompt, through this
        engine's dispatch context (no cache is kept)."""
        tokens = torch.as_tensor(np.asarray(prompt), dtype=torch.long, device=self.device)
        with self._dispatch_ctx():
            logits, _ = self.model.prefill(self.params, tokens[None, :], div=self.div)
        return logits

    def _prefill_slot(self, slot: int, req: Request):
        """Prefill one request, then copy its cache into the shared pool at
        the slot index."""
        t0 = self._timer()
        tokens = torch.as_tensor(req.prompt, dtype=torch.long, device=self.device)[None, :]
        with self._dispatch_ctx():
            logits, cache1 = self.model.prefill(
                self.params, tokens, max_seq=self.cfg.max_seq, div=self.div
            )
        for key, leaf in cache1["attn"].items():  # k/v, and their scales for an int8 cache
            self.cache["attn"][key][:, slot] = leaf[:, 0]
        self.pos[slot] = len(req.prompt)
        self.slot_req[slot] = req
        tok = self._sample(logits[0, -1].float().cpu().numpy(), req.temperature)
        self.timing["prefill_s"] += self._timer() - t0
        self.timing["prefill_tokens"] += len(req.prompt)
        req.out_tokens.append(tok)
        full = self.pos[slot] >= self.cfg.max_seq
        if tok == self.cfg.eos or len(req.out_tokens) >= req.max_new_tokens or full:
            req.done = True
            self.slot_req[slot] = None
            self.pos[slot] = 0

    def step(self) -> bool:
        """One decode step for every active slot."""
        self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return False
        t0 = self._timer()
        tokens = np.zeros((self.cfg.n_slots, 1), np.int64)
        for i in active:
            tokens[i, 0] = self.slot_req[i].out_tokens[-1]
        with self._dispatch_ctx():
            logits, self.cache = self.model.decode_step(
                self.params,
                self.cache,
                torch.as_tensor(tokens, device=self.device),
                torch.as_tensor(self.pos, device=self.device),
                div=self.div,
            )
        logits_np = logits[:, 0].float().cpu().numpy()
        self.timing["decode_s"] += self._timer() - t0
        self.timing["decode_steps"] += 1
        self.timing["decode_tokens"] += len(active)
        for i in active:
            req = self.slot_req[i]
            self.pos[i] += 1
            tok = self._sample(logits_np[i], req.temperature)
            req.out_tokens.append(tok)
            full = self.pos[i] >= self.cfg.max_seq
            if len(req.out_tokens) >= req.max_new_tokens or tok == self.cfg.eos or full:
                req.done = True
                self.slot_req[i] = None
                self.pos[i] = 0
        self._maybe_adapt()
        return True
