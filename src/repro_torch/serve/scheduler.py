"""Request scheduling over paged KV: admission control and chunked prefill
interleaved with decode (counterpart of ``repro.serve.scheduler``).

The dense :class:`~repro_torch.serve.engine.ServeEngine` couples three
things this engine decouples:

* **capacity** — KV memory is a page pool (``paged_kv``), so how many
  sequences are *resident* is bounded by the sum of their actual lengths,
  not ``n_slots * max_seq``;
* **admission** — ``submit`` is an asynchronous enqueue with queue-depth
  backpressure (:class:`AdmissionError` when the queue is full; callers
  retry later), and the scheduler admits *oldest-first* under a page-budget
  watermark: a request enters only when its whole prompt fits AND a reserve
  stays free for the decode growth of sequences already resident. Nothing
  is ever evicted; admission is the only throttle;
* **prefill** — long prompts prefill in chunks of ``prefill_chunk`` tokens,
  at most one chunk per engine step, so a long prompt contributes one
  bounded unit of work between decode batches.

Decode runs at the fixed batch width ``max_active`` over a gathered,
position-contiguous page view, so the decode GEMM fingerprints (M =
``max_active``) are the dense engine's, and tuned dispatch, the adaptive
tuner and hot swaps work as they do there. Runnable requests are packed at
the front of the batch in admission order; the rest are scratch-page rows.
Page exhaustion mid-decode *stalls* a sequence until a page frees; if every
resident sequence is stalled and nothing else can move, the oldest is
retired early with ``truncated=True``.

On the card every prefill, chunk and decode step runs its GEMMs on the
``cuda`` backend (the hand-written kernels) unless the caller names another;
gathers and scatters are indexed copies on the pool's device. A decode step
splits into a host part (page ids, offsets, the scratch check) and a device
part on tensors alone (gather, ``decode_step``, scatter), which on the card
is a CUDA graph's replay per padded table width
(:mod:`repro_torch.serve.graphs`); chunked prefill stays eager.
"""

from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.adaptive import AdaptiveTuner
from repro_torch.core.selector import KernelSelector
from repro_torch.serve.engine import EngineCore, Request
from repro_torch.serve.graphs import DecodeStep
from repro_torch.serve.paged_kv import PagedKVCache, PageTable

log = logging.getLogger("repro_torch.serve.paged")


class AdmissionError(RuntimeError):
    """Queue-depth backpressure: the request queue is full; retry later."""


@dataclass
class PagedServeConfig:
    """Pool geometry, decode width, admission and prefill settings."""

    page_size: int = 16
    max_pages: int = 64
    max_active: int = 8  # decode batch width (fixed; padded with scratch rows)
    max_seq: int = 512  # per-sequence logical cap (prompt + decoded tokens)
    max_queue: int = 0  # queued-request cap; 0 = unbounded (no backpressure)
    watermark: float = 0.1  # fraction of the pool reserved at admission time
    prefill_chunk: int = 0  # tokens per prefill tick; 0 = whole-prompt prefill
    eos: int = 0
    seed: int = 0

    @property
    def reserve_pages(self) -> int:
        """Pages the watermark keeps free at admission."""
        return math.ceil(self.watermark * self.max_pages)


@dataclass
class PagedRequest(Request):
    """Request + paged lifecycle state + SLO stamps (engine steps and
    monotonic wall seconds)."""

    table: PageTable = field(default_factory=PageTable)
    prefilled: int = 0  # prompt tokens already prefilled
    pos: int = 0  # next KV write position (== prompt + decoded so far)
    stalled: bool = False  # waiting on a free page to keep decoding
    submit_step: int = -1
    first_token_step: int = -1
    done_step: int = -1
    submit_wall: float = 0.0
    first_token_wall: float = 0.0
    done_wall: float = 0.0


class PagedServeEngine(EngineCore):
    """Continuous batching over a paged KV pool with admission control."""

    def __init__(
        self,
        model,
        params,
        cfg: PagedServeConfig,
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
            batch_hint=cfg.max_active,
            selector=selector,
            backend=backend,
            device=device,
            adaptive=adaptive,
            adapt_every=adapt_every,
        )
        if cfg.max_active < 1:
            raise ValueError(f"max_active must be >= 1, got {cfg.max_active}")
        self.cfg = cfg
        self.kv = PagedKVCache(model, page_size=cfg.page_size, n_pages=cfg.max_pages,
                               device=self.device)
        self.active: List[PagedRequest] = []  # admission order
        # admission/SLO counters
        self.admitted = 0
        self.rejected = 0  # queue-depth backpressure refusals
        self.truncated = 0  # anti-deadlock early retirements
        self.stall_events = 0  # decode ticks skipped for want of a page
        self.peak_resident = 0
        #: the decode step, compiled per padded table width where the mode is
        #: "graph" (``kv.pool`` is written in place and never rebound)
        self.decode = DecodeStep(self, self._paged_step)

    # -- paged steps ---------------------------------------------------------
    def _tensor(self, a, dtype=torch.long) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _paged_decode(self, pages_2d: np.ndarray, tokens: np.ndarray, pos: np.ndarray,
                      n_real: int):
        """The host part of a paged decode step: each row's page and offset
        on the host, the scratch check, then the device step
        (:meth:`_paged_step`) through the compiled step, keyed on the padded
        table width (at most log2(max_seq / page_size) + 1 widths)."""
        ps = self.kv.page_size
        pg = pages_2d[np.arange(len(pos)), pos // ps]
        # padded rows all write the scratch row, in any order on the card, so
        # no real row may alias it
        if (pg[:n_real] == self.kv.scratch).any():
            raise RuntimeError(f"a real decode row maps to the scratch page: {pg[:n_real]}")
        return self.decode(pages_2d.shape[1], tokens=tokens, pos=pos, pages=pages_2d, page=pg,
                           offset=pos % ps)

    def _paged_step(self, bufs) -> torch.Tensor:
        """The device part, on tensors only: gather the view -> the
        unchanged ``model.decode_step`` (which writes the new row into the
        view) -> scatter the one new row per sequence back into its page."""
        view = self.kv.gather_view(self.kv.pool, bufs["pages"])
        logits, view = self.model.decode_step(self.params, view, bufs["tokens"], bufs["pos"],
                                              div=self.div)
        self.kv.scatter_rows(self.kv.pool, bufs["page"], bufs["offset"],
                             self.kv.rows_at(view, bufs["pos"]))
        return logits

    def _paged_chunk(self, pages_2d: np.ndarray, chunk: np.ndarray, start: int):
        """One prompt chunk of one sequence (B == 1): gather its pages, run
        ``model.prefill_chunk``, scatter the chunk's rows back."""
        ps = self.kv.page_size
        pos_block = start + np.arange(chunk.shape[1])  # (C,)
        pg = pages_2d[0, pos_block // ps]
        if (pg == self.kv.scratch).any():
            raise RuntimeError(f"a prompt row maps to the scratch page: {pg}")
        view = self.kv.gather_view(self.kv.pool, pages_2d)
        logits, view = self.model.prefill_chunk(self.params, view, self._tensor(chunk),
                                                self._tensor([start]), div=self.div)
        rows = {"attn": {key: a[:, 0, self._tensor(pos_block)]
                         for key, a in view["attn"].items()}}
        self.kv.scatter_rows(self.kv.pool, pg, pos_block % ps, rows)
        return logits

    # -- submission --------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 32, temperature: float = 0.0) -> int:
        """Asynchronous enqueue. Raises :class:`AdmissionError` when the
        queue is at ``max_queue`` (backpressure; the caller retries), and
        ``ValueError`` for prompts that could never be admitted (empty, over
        ``max_seq``, or needing more pages than the pool can ever spare past
        the watermark reserve)."""
        prompt = self._validate_prompt(prompt)
        need = self.kv.pages_for(len(prompt))
        budget = self.cfg.max_pages - self.cfg.reserve_pages
        if need > budget:
            raise ValueError(
                f"prompt needs {need} pages; admissible budget is {budget} "
                f"({self.cfg.max_pages} pages minus {self.cfg.reserve_pages} "
                "watermark reserve)"
            )
        if self.cfg.max_queue and len(self._queue) >= self.cfg.max_queue:
            self.rejected += 1
            raise AdmissionError(
                f"queue full ({len(self._queue)}/{self.cfg.max_queue}); "
                "retry after the engine drains"
            )
        self._uid += 1
        req = PagedRequest(self._uid, prompt, max_new_tokens, temperature)
        req.submit_step = self._steps
        req.submit_wall = time.monotonic()
        self._queue.append(req)
        return self._uid

    def outstanding(self) -> List[Request]:
        """Requests still queued or resident."""
        return list(self._queue) + [r for r in self.active if not r.done]

    # -- admission ---------------------------------------------------------
    def _admit(self) -> int:
        """Oldest-first admission under the page watermark: the queue head
        enters only when its whole prompt's pages fit with the reserve left
        over. No skipping ahead and no eviction."""
        n = 0
        while self._queue and len(self.active) < self.cfg.max_active:
            head = self._queue[0]
            need = self.kv.pages_for(len(head.prompt))
            if self.kv.free_pages - need < self.cfg.reserve_pages:
                break
            self._queue.pop(0)
            head.table = PageTable(self.kv.alloc(need), 0)
            self.active.append(head)
            self.admitted += 1
            n += 1
        self.peak_resident = max(self.peak_resident, len(self.active))
        return n

    # -- prefill -----------------------------------------------------------
    def _pending_prefill(self) -> Optional[PagedRequest]:
        for r in self.active:
            if r.prefilled < len(r.prompt):
                return r
        return None

    def _prefill_tick(self) -> bool:
        """Advance the oldest prefilling request by one chunk (or its whole
        prompt when ``prefill_chunk`` is 0). Returns True if work ran."""
        req = self._pending_prefill()
        if req is None:
            return False
        t0 = self._timer()
        remaining = len(req.prompt) - req.prefilled
        chunk = remaining
        if self.cfg.prefill_chunk > 0:
            chunk = min(self.cfg.prefill_chunk, remaining)
        start = req.prefilled
        tokens = np.asarray(req.prompt[start : start + chunk], np.int64)[None, :]
        ps = self.kv.page_size
        with self._dispatch_ctx():
            if start == 0:
                # the whole prompt (the dense engine's model.prefill call and
                # numerics, at max_seq = the table's capacity), or the first
                # chunk (no prefix to attend over: prefilled at its own
                # page-padded length), scattered into the request's pages
                n_pages = req.table.capacity if chunk == len(req.prompt) else (
                    self.kv.pages_for(chunk))
                logits, fresh = self.model.prefill(self.params, self._tensor(tokens),
                                                   max_seq=n_pages * ps, div=self.div)
                self.kv.scatter_prefill(self.kv.pool, req.table.pages[:n_pages], fresh)
            else:
                logits = self._paged_chunk(self.kv.padded_tables([req.table]), tokens, start)
        req.prefilled += chunk
        req.table.length = req.prefilled
        self.timing["prefill_tokens"] += chunk
        if req.prefilled < len(req.prompt):
            self.timing["prefill_s"] += self._timer() - t0
            return True
        # prompt complete: sample the first token (the dense engine's contract)
        req.pos = len(req.prompt)
        tok = self._sample(logits[0, -1].float().cpu().numpy(), req.temperature)
        self.timing["prefill_s"] += self._timer() - t0
        req.out_tokens.append(int(tok))
        req.first_token_step = self._steps
        req.first_token_wall = time.monotonic()
        full = req.pos >= self.cfg.max_seq
        if tok == self.cfg.eos or len(req.out_tokens) >= req.max_new_tokens or full:
            self._retire(req)
        return True

    # -- decode ------------------------------------------------------------
    def _decode_candidates(self) -> List[PagedRequest]:
        return [r for r in self.active if not r.done and r.prefilled == len(r.prompt)]

    def _ensure_page(self, req: PagedRequest) -> bool:
        """Guarantee ``req.pos`` has a page to write to; stall on exhaustion."""
        if req.pos < req.table.capacity * self.kv.page_size:
            req.stalled = False
            return True
        got = self.kv.try_alloc(1)
        if got is None:
            if not req.stalled:
                self.stall_events += 1
            req.stalled = True
            return False
        req.table.pages.extend(got)
        req.stalled = False
        return True

    def _decode_tick(self) -> bool:
        cand = self._decode_candidates()
        runnable = [r for r in cand if self._ensure_page(r)]
        if not runnable:
            return False
        t0 = self._timer()
        b = self.cfg.max_active
        runnable = runnable[:b]
        tokens = np.zeros((b, 1), np.int64)
        pos = np.zeros((b,), np.int64)
        tables = []
        for i, r in enumerate(runnable):
            tokens[i, 0] = r.out_tokens[-1]
            pos[i] = r.pos
            tables.append(r.table)
        # pad the batch to the fixed decode width with scratch-page rows
        tables.extend(PageTable() for _ in range(b - len(runnable)))
        logits = self._paged_decode(self.kv.padded_tables(tables), tokens, pos, len(runnable))
        logits_np = logits[:, 0].float().cpu().numpy()
        self.timing["decode_s"] += self._timer() - t0
        self.timing["decode_steps"] += 1
        self.timing["decode_tokens"] += len(runnable)
        for i, req in enumerate(runnable):
            req.pos += 1
            req.table.length = req.pos
            tok = self._sample(logits_np[i], req.temperature)
            req.out_tokens.append(tok)
            if (
                tok == self.cfg.eos
                or len(req.out_tokens) >= req.max_new_tokens
                or req.pos >= self.cfg.max_seq
            ):
                self._retire(req)
        return True

    def _retire(self, req: PagedRequest, truncated: bool = False):
        req.done = True
        req.truncated = truncated
        req.done_step = self._steps
        req.done_wall = time.monotonic()
        if truncated and req.first_token_wall == 0.0:
            req.first_token_step = self._steps
            req.first_token_wall = req.done_wall
        self.kv.free(req.table.pages)
        req.table = PageTable()
        self.active.remove(req)

    # -- one scheduling quantum --------------------------------------------
    def step(self) -> bool:
        """Admit, prefill (one chunk, or whole prompts until nothing moves),
        then one decode step; False when there was nothing to do."""
        progress = 0
        if self.cfg.prefill_chunk > 0:
            # chunked mode: ONE bounded prefill quantum per step, so long
            # prompts interleave with the decode batch below
            progress += self._admit()
            progress += int(self._prefill_tick())
        else:
            # whole-prompt mode: admit/prefill until the pool or the queue
            # is exhausted (a retirement at prefill frees pages mid-loop)
            while True:
                a = self._admit()
                w = int(self._prefill_tick())
                progress += a + w
                if not (a or w):
                    break
        progress += int(self._decode_tick())
        if not progress:
            if self.active:
                # every resident sequence is stalled on page exhaustion and
                # nothing else can move: retire the oldest (truncated) so its
                # pages unblock the rest, never deadlock the loop
                victim = self.active[0]
                log.warning(
                    "page pool gridlock (%d resident, 0 free of %d pages): "
                    "truncating request %d at %d tokens",
                    len(self.active), self.kv.n_pages, victim.uid, len(victim.out_tokens),
                )
                self.truncated += 1
                self._retire(victim, truncated=True)
                self._maybe_adapt()
                return True
            return False  # drained (submit() rejects never-admissible work)
        self._maybe_adapt()
        return True

    # -- observability -----------------------------------------------------
    def metrics(self) -> Dict[str, float]:
        """Pool occupancy with the admission and SLO counters."""
        occ = self.kv.occupancy()
        occ.update(
            admitted=self.admitted,
            rejected=self.rejected,
            truncated=self.truncated,
            stall_events=self.stall_events,
            peak_resident=self.peak_resident,
            resident=len(self.active),
            queued=len(self._queue),
            steps=self._steps,
        )
        return occ
