"""Block/paged KV allocation for the serving path (counterpart of
``repro.serve.paged_kv``).

The dense engine gives every slot a ``max_seq`` stripe of the stacked KV
cache, so resident concurrency is capped at ``n_slots`` and the memory bill
is ``n_slots * max_seq`` token rows whether sequences use them or not. Here
KV lives in a pool of fixed-size *pages* — the port's cache layout with
(batch, seq) replaced by (n_pages + 1, page_size): K/V leaves
``(L, n_pages + 1, page_size, KV, dh)``, and under ``kv_cache_dtype="int8"``
their f32 scales ``(L, n_pages + 1, page_size, KV)`` — and each sequence
holds an ordered *page table* mapping logical position ``p`` to row
``(table[p // page_size], p % page_size)``. Resident concurrency is then
bounded by the sum of actual sequence lengths, rounded up per sequence.

Integration contract: ``model.prefill`` / ``model.decode_step`` and the
dispatch fingerprints they produce stay untouched. The adapters below
*gather* a batch's pages into a dense, position-contiguous view (page ``i``
of a table holds positions ``i*page_size .. (i+1)*page_size - 1``, so the
concatenated pages ARE the dense layout and the attention mask ``kpos <=
cur_pos`` hides the allocated-but-unwritten rows as it does the dense
cache's), the unchanged model step runs on the view, and only the newly
written rows are *scattered* back into the pool. The view is a copy
(advanced indexing), so the model's in-place writes land in the view, never
in the pool: the caller reads them back with :meth:`PagedKVCache.rows_at`
and scatters them.

The pool carries one extra *scratch* page (index ``n_pages``): padding
entries of short page tables and the write-back targets of padded batch
rows point at it, so every gather and scatter is one indexed copy. Several
padded rows write the same scratch row, and an indexed write with duplicate
indices picks an arbitrary writer on the card; that is harmless because no
real row ever maps to the scratch page, which the engine asserts.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.lm import resolve_device


class PageExhausted(RuntimeError):
    """The free list cannot cover an allocation request."""


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` positions (>= 1: even an empty
    table reserves the page its first decode token will write)."""
    return max(1, -(-int(n_tokens) // page_size))


@dataclass
class PageTable:
    """One sequence's ordered page list + how many positions are written."""

    pages: List[int] = field(default_factory=list)
    length: int = 0

    @property
    def capacity(self) -> int:
        """Pages held (tokens: ``capacity * page_size``)."""
        return len(self.pages)


def paged_cache_specs(model, page_size: int) -> Dict[str, tuple]:
    """Shapes of one *page* of the model's decode cache, by leaf: the
    model's cache layout with (batch, seq) -> (1, page_size). Raises for
    cache layouts that cannot page (SSM/hybrid state, ring caches), as
    ``repro``'s ``paged_cache_specs``."""
    cfg = model.cfg
    if cfg.family not in ("dense", "vlm", "moe"):
        raise ValueError(
            f"paged KV supports the attention-cache families (dense/vlm/moe); "
            f"{cfg.family!r} decode state is O(1) per sequence and gains "
            "nothing from paging"
        )
    if cfg.window_cache and cfg.global_every:
        raise ValueError(
            "paged KV requires the uniform decode cache; ring caches "
            "already bound local-layer memory at O(window)"
        )
    cache = model.init_cache(1, page_size, device="meta")
    if set(cache) != {"attn"}:
        raise ValueError(f"unexpected cache layout {sorted(cache)!r}")
    return {key: tuple(leaf.shape) for key, leaf in cache["attn"].items()}


def _index(idx, device) -> torch.Tensor:
    return torch.as_tensor(idx, dtype=torch.long, device=device)


class PagedKVCache:
    """Page pool + free-list allocator + gather/scatter adapters.

    ``pool`` is the model's cache tree (``{"attn": {"k", "v"[, "k_scale",
    "v_scale"]}}``) with the (batch, seq) axes replaced by (n_pages + 1,
    page_size), on ``device``; page ``n_pages`` is the scratch page (see
    the module doc). Allocation is FIFO-recycled: freed pages go to the back
    of the free list, so a page's stale contents age out instead of being
    re-read by the next gather at once (any stale row is masked regardless).
    """

    def __init__(self, model, *, page_size: int, n_pages: int, device=None):
        if page_size < 1 or n_pages < 1:
            raise ValueError(f"bad pool geometry {page_size=} {n_pages=}")
        self.page_size = int(page_size)
        self.n_pages = int(n_pages)
        self.scratch = self.n_pages  # reserved page id for padded rows
        paged_cache_specs(model, page_size)
        self.device = resolve_device(device)
        # (L, n_pages + 1, page_size, ...): the cache layout at batch n_pages + 1
        self.pool = model.init_cache(self.n_pages + 1, self.page_size, device=self.device)
        self._free: deque = deque(range(self.n_pages))
        self.peak_used = 0

    # -- allocator --------------------------------------------------------
    @property
    def free_pages(self) -> int:
        """Pages on the free list."""
        return len(self._free)

    @property
    def used_pages(self) -> int:
        """Pages held by page tables."""
        return self.n_pages - len(self._free)

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` positions (>= 1)."""
        return pages_for(n_tokens, self.page_size)

    def try_alloc(self, n: int) -> Optional[List[int]]:
        """``n`` pages off the free list, or None (state unchanged) if the
        budget cannot cover them."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            return None
        pages = [self._free.popleft() for _ in range(n)]
        self.peak_used = max(self.peak_used, self.used_pages)
        return pages

    def alloc(self, n: int) -> List[int]:
        """``n`` pages off the free list; :class:`PageExhausted` if it
        cannot cover them."""
        pages = self.try_alloc(n)
        if pages is None:
            raise PageExhausted(f"need {n} pages, {len(self._free)}/{self.n_pages} free")
        return pages

    def free(self, pages: List[int]):
        """Return ``pages`` to the back of the free list; raises on an
        invalid id or a double free."""
        for p in pages:
            if not 0 <= p < self.n_pages:
                raise ValueError(f"freeing invalid page id {p}")
            if p in self._free:
                raise ValueError(f"double free of page {p}")
        self._free.extend(pages)

    def occupancy(self) -> Dict[str, float]:
        """Pool size, pages used and free, the peak, and utilization."""
        return {
            "n_pages": self.n_pages,
            "used_pages": self.used_pages,
            "free_pages": self.free_pages,
            "peak_used_pages": self.peak_used,
            "utilization": self.used_pages / self.n_pages,
        }

    # -- tensor adapters ---------------------------------------------------
    # Leaf layout: pool (L, NP, PS, *r), dense cache/view (L, B, S, *r); *r is
    # (KV, dh) for K/V and (KV,) for the int8 cache's scales. Index arguments
    # are numpy arrays, lists or tensors.

    def gather_view(self, pool, pages_2d):
        """Dense position-contiguous view (a copy) of a batch of page
        tables. ``pages_2d``: (B, P) page ids, short tables padded with
        scratch. Leaf: (L, NP, PS, *r) -> (L, B, P*PS, *r)."""

        def leaf(a):
            idx = _index(pages_2d, a.device)
            g = a[:, idx]  # (L, B, P, PS, *r)
            return g.reshape(g.shape[0], idx.shape[0], -1, *g.shape[4:])

        return {"attn": {key: leaf(a) for key, a in pool["attn"].items()}}

    def scatter_rows(self, pool, page_ids, offsets, rows):
        """Write one row per batch element IN PLACE: ``rows`` leaf (L, B, *r)
        lands at ``pool[:, page_ids[b], offsets[b]]``. Padded batch rows must
        point ``page_ids`` at the scratch page. Returns ``pool``."""
        for key, a in pool["attn"].items():
            a[:, _index(page_ids, a.device), _index(offsets, a.device)] = rows["attn"][key]
        return pool

    def rows_at(self, view, pos):
        """The per-sequence row at ``pos`` (B,) of a dense view:
        leaf (L, B, S, *r) -> (L, B, *r)."""

        def leaf(a):
            return a[:, torch.arange(a.shape[1], device=a.device), _index(pos, a.device)]

        return {"attn": {key: leaf(a) for key, a in view["attn"].items()}}

    def scatter_prefill(self, pool, pages, fresh):
        """Write one sequence's freshly prefilled cache into its pages IN
        PLACE. ``fresh`` leaf (L, 1, S_pad, *r) with S_pad == len(pages)*PS
        (the caller prefills at the page-padded length); ``pages``: (P,).
        Returns ``pool``."""
        for key, a in pool["attn"].items():
            f = fresh["attn"][key]
            idx = _index(pages, a.device)
            a[:, idx] = f[:, 0].reshape(f.shape[0], idx.shape[0], self.page_size, *f.shape[3:])
        return pool

    def padded_tables(self, tables: List[PageTable], min_pages: int = 1) -> np.ndarray:
        """(B, P) int32 page ids of a batch of tables on the host, P = the
        longest table padded up to a power of two (at most
        log2(max_seq/page_size) distinct view shapes); scratch-padded."""
        p = max(min_pages, *(len(t.pages) for t in tables)) if tables else min_pages
        p_pad = 1
        while p_pad < p:
            p_pad *= 2
        out = np.full((len(tables), p_pad), self.scratch, np.int32)
        for i, t in enumerate(tables):
            out[i, : len(t.pages)] = t.pages
        return out
