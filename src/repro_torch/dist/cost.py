"""Per-device cost accounting of a traced step (the port's counterpart of
``repro.dist.hlo`` and ``repro.dist.hlo_cost``).

``repro`` reads its numbers from the compiled HLO: FLOPs from XLA's cost
analysis (and a loop-aware re-count of while bodies), argument bytes from
the memory analysis, collective bytes from the collectives in the text.
The port has no HLO, so nothing here parses text:

* **FLOPs** come from ``torch.utils.flop_counter.FlopCounterMode`` over the
  step traced on the meta device (:class:`StepFlops`): forward, the
  recompute of remat'd layers, backward. The share of it that the Stream-K++
  dispatch issued (every ``gemm``/``gemm_grouped`` the ``torch`` backend ran
  during the trace) is counted apart, so it can be held against
  ``2 * sum(G * M * N * K)`` over the dispatch log.
* **Argument bytes** are summed leaf by leaf from each shard's local shape
  under the plan's :meth:`~repro_torch.dist.sharding.ShardingPlan.spec_for`
  (:func:`tree_local_bytes`): parameters, the optimizer state mirroring
  them, caches and inputs.
* **Collective bytes** are recorded as one rank's step runs them, at
  their local shapes (``repro_torch.dist.collectives``: ``record`` over a
  virtual host mesh, ``launch/dryrun.py trace_local``).
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Iterator, Optional

import torch

from repro_torch.core import gemm as gemm_mod
from repro_torch.core.gemm import dtype_name
from repro_torch.dist.sharding import (MOMENT_KEYS, ArraySpec, ShardingPlan, moment_spec,
                                       spec_dtype, spec_items)


def local_bytes(plan: ShardingPlan, spec: ArraySpec) -> int:
    """Bytes one device holds of the array ``spec`` under ``plan``."""
    itemsize = torch.empty((), dtype=spec_dtype(spec.dtype)).element_size()
    return math.prod(plan.local_shape(spec)) * itemsize


def tree_local_bytes(plan: ShardingPlan, specs) -> int:
    """:func:`local_bytes` summed over an ArraySpec tree."""
    return sum(local_bytes(plan, s) for _, s in spec_items(specs))


def specs_like(tensors, mirror=None):
    """ArraySpec tree of a tree of tensors (meta or real): each leaf's shape
    and dtype, with the logical axes of the leaf at the same path of
    ``mirror`` (an ArraySpec tree: the parameters an optimizer state mirrors)
    where its shape matches, an Adafactor moment's those of its parameter
    without the reduced dim (``moment_spec``), else replicated (a counter)."""
    want = dict(spec_items(mirror)) if mirror is not None else {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in tree.items()}
        shape = tuple(tree.shape)
        path = prefix[:-1]
        ref = want.get(path)
        parent, _, key = path.rpartition("/")
        if (ref is None or ref.shape != shape) and key in MOMENT_KEYS and parent in want:
            ref = moment_spec(want[parent], key)
        axes = ref.axes if ref is not None and ref.shape == shape else (None,) * len(shape)
        return ArraySpec(shape, dtype_name(tree.dtype), axes)

    return walk(tensors, "")


def dispatch_flops(log) -> int:
    """``2 * G * M * N * K`` summed over a dispatch log's global dims: the
    multiply-adds the logged GEMMs ask for."""
    return sum(2 * e.op.g * e.op.m * e.op.n * e.op.k for e in log)


class StepFlops:
    """FLOPs of what runs inside the block (``FlopCounterMode``), and apart
    from them, :attr:`dispatch` — those the ``torch`` backend of the GEMM
    dispatch ran (on the meta device every dispatch takes that backend).

    The ``torch`` backend is wrapped for the block; each of its calls adds
    the counter's growth over the call. Autograd differentiates the
    ``torch`` backend directly, so a backward product is counted in
    :attr:`total` but never in :attr:`dispatch`; a remat recompute is a
    logged dispatch and counts in both."""

    def __init__(self):
        from torch.utils.flop_counter import FlopCounterMode

        self.counter = FlopCounterMode(display=False)
        self.dispatch = 0
        self.total = 0

    @contextmanager
    def _counted_torch_backend(self) -> Iterator[None]:
        plain = gemm_mod.get_backend("torch")

        def counted(x, w, **kw):
            before = self.counter.get_total_flops()
            out = plain(x, w, **kw)
            self.dispatch += self.counter.get_total_flops() - before
            return out

        gemm_mod.register_backend("torch", counted, overwrite=True)
        try:
            yield
        finally:
            gemm_mod.register_backend("torch", plain, overwrite=True)

    def __enter__(self) -> "StepFlops":
        self._backend = self._counted_torch_backend()
        self._backend.__enter__()
        self.counter.__enter__()
        return self

    def __exit__(self, *exc) -> Optional[bool]:
        self.counter.__exit__(*exc)
        self._backend.__exit__(*exc)
        self.total = self.counter.get_total_flops()
        return None
