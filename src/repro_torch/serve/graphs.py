"""The compiled decode step of both serving engines (counterpart of
``repro``'s ``jax.jit(..., donate_argnums=(1,))`` of the decode step,
``repro.serve.engine`` and ``repro.serve.scheduler``).

Each engine runs its decode step through one :class:`DecodeStep`. Where
:func:`step_mode` says ``"graph"`` (a CUDA device without a ranked plan),
the first step of each key runs eagerly once, the warm-up: it builds or
loads the kernel library, resolves and memoises the selections, sizes the
arrival counters, fills B5's row-block tables and makes the tied head's
copy, and its logits are that step's. The step is then captured as a
``torch.cuda.CUDAGraph``; every later step of the key copies its inputs
into the step's static device buffers and replays the graph, whose logits
are a static output. The cache is the graph's own: the step writes it in
place (the counterpart of donation), and the engine never rebinds it.

The key is the engine's shape key and the selector's swap count: after a
hot swap (an adaptation, a gossip round) the next step captures anew, so a
replay never serves picks an eager step would no longer make. ``repro``'s
jit cache is keyed on shapes alone and keeps its trace's picks (ROADMAP
§C). Selection, the selection log and the adaptive tuner's miss hook run
where dispatch runs, at warm-up and at capture, as ``repro``'s run at
trace time; the kernels' launch counters count a replay's captured
launches once per replay (``kernels.common.replay_launches``).

``"eager"`` -- on the CPU, under :func:`disable_graphs` (the counterpart of
``jax.disable_jit()``), and under a ranked plan (``gloo`` collectives are
host calls that cannot be captured; NCCL capture is later work) -- runs
the same static-buffer path without a graph. A capture or a replay that
fails where ``"graph"`` applies raises; nothing falls back to eager.
"""

from __future__ import annotations

import gc
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.dist.sharding import ranked_plan
from repro_torch.kernels.common import capturing, replay_launches

#: open :func:`disable_graphs` scopes
_disabled = 0


@contextmanager
def disable_graphs() -> Iterator[None]:
    """Within the scope every engine runs its decode step eagerly, through
    the same static buffers (``jax.disable_jit()``'s counterpart)."""
    global _disabled
    _disabled += 1
    try:
        yield
    finally:
        _disabled -= 1


def step_mode(device) -> str:
    """``"graph"`` on a CUDA device without a ranked plan, outside
    :func:`disable_graphs`; ``"eager"`` otherwise."""
    if _disabled or torch.device(device).type != "cuda" or ranked_plan() is not None:
        return "eager"
    return "graph"


class CudaGraphs:
    """The card's side of one :class:`DecodeStep`: a memory pool all its
    captures share (they never replay at once) and the stream they are
    captured on."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)

    @contextmanager
    def warmup(self) -> Iterator[None]:
        """Run the scope on the capture stream, after the current stream's
        work and before its next: what the warm-up sets up lazily on a
        stream (the library's handles, a workspace) then exists for the
        capture."""
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            yield
        current.wait_stream(self.stream)

    def capture(self, fn: Callable[[], torch.Tensor]):
        """Capture ``fn`` as a CUDA graph; returns (the replay, which
        launches the graph and returns what ``fn`` returned at capture, its
        static output; the bytes the card reserved across the capture)."""
        gc.collect()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            out = fn()
        torch.cuda.synchronize(self.device)

        def replay() -> torch.Tensor:
            graph.replay()
            return out

        return replay, torch.cuda.memory_reserved(self.device) - reserved


@dataclass
class Captured:
    """One captured step: its key, the launches it replays, the selections
    dispatched at its capture, the seconds of its warm-up and capture, the
    bytes the card reserved across the capture (the graph's pool), and its
    replays so far. ``replay`` is None once a swap has retired it."""

    key: tuple
    launches: List[str]
    selections: list
    seconds: float
    pool_bytes: int
    replay: Optional[Callable[[], torch.Tensor]] = None
    replays: int = 0
    #: device tensors the graph reads that the wrappers made outside it
    held: List[torch.Tensor] = field(default_factory=list, repr=False)


class DecodeStep:
    """One engine's decode step, ``fn(buffers) -> logits``, where
    ``buffers`` maps each input's name to its static int64 device buffer.
    Called with the engine's shape key and the inputs as host arrays; runs
    eagerly or by graph replay as :func:`step_mode` says (module doc).
    ``engine`` gives the device, the selector and ``_dispatch_ctx``."""

    def __init__(self, engine, fn: Callable[[Dict[str, torch.Tensor]], torch.Tensor]):
        self.engine = engine
        self.fn = fn
        #: static input buffers, by the inputs' (name, shape) signature
        self.buffers: Dict[tuple, Dict[str, torch.Tensor]] = {}
        #: every capture, in order (retired ones too)
        self.captured: List[Captured] = []
        self._live: Dict[tuple, Captured] = {}
        self._graphs: Optional[CudaGraphs] = None

    @property
    def mode(self) -> str:
        """This step's :func:`step_mode` now."""
        return step_mode(self.engine.device)

    @property
    def replays(self) -> int:
        """Replays of every capture so far."""
        return sum(c.replays for c in self.captured)

    def load(self, inputs: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Copy the host ``inputs`` into their static buffers (made at the
        first call of each signature) and return the buffers."""
        sig = tuple((name, np.shape(a)) for name, a in inputs.items())
        bufs = self.buffers.get(sig)
        if bufs is None:
            bufs = self.buffers[sig] = {
                name: torch.empty(np.shape(a), dtype=torch.long, device=self.engine.device)
                for name, a in inputs.items()}
        for name, a in inputs.items():
            self.copy_in(name, bufs[name], a)
        return bufs

    def copy_in(self, name: str, buf: torch.Tensor, a) -> None:
        """Copy the host input ``name`` into its static buffer."""
        buf.copy_(torch.from_numpy(np.asarray(a, np.int64)))

    def __call__(self, key, **inputs) -> torch.Tensor:
        bufs = self.load(inputs)
        if self.mode == "eager":
            with self.engine._dispatch_ctx():
                return self.fn(bufs)
        key = (key, self.engine.selector.swaps)
        graph = self._live.get(key)
        if graph is None:
            return self._capture(key, bufs)
        out = graph.replay()
        replay_launches(graph.launches)
        graph.replays += 1
        return out

    def _capture(self, key: tuple, bufs: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Warm up, then capture the step of ``key``; returns the warm-up's
        logits, this step's."""
        eng = self.engine
        for old in [k for k in self._live if k[1] != key[1]]:  # an earlier swap's picks
            self._live.pop(old).replay = None
        if self._graphs is None:
            self._graphs = CudaGraphs(eng.device)
        t0 = time.perf_counter()
        with self._graphs.warmup(), eng._dispatch_ctx():
            out = self.fn(bufs)
        n_logged = len(eng.selection_log)
        with eng._dispatch_ctx(), capturing() as cap:
            replay, pool_bytes = self._graphs.capture(lambda: self.fn(bufs))
        graph = Captured(key=key, launches=cap.launches, selections=eng.selection_log[n_logged:],
                         seconds=time.perf_counter() - t0, pool_bytes=pool_bytes, replay=replay,
                         held=cap.held)
        self.captured.append(graph)
        self._live[key] = graph
        return out
