"""Wall-clock helpers (the port's copy of ``repro.utils.timing``): a
context-manager timer and the EWMA the straggler monitor reads."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import torch


class Timer:
    """``with Timer() as t: ...; t.seconds``.

    With ``device`` a CUDA device the timer synchronises it on exit, so
    ``seconds`` covers the work the block queued and not only the host's
    time to enqueue it (the counterpart of ``jax.block_until_ready`` in
    ``repro``'s trainer)."""

    def __init__(self, device: Optional[torch.device] = None):
        self.device = None if device is None else torch.device(device)

    def __enter__(self):
        self._t0 = time.perf_counter()
        self.seconds = 0.0
        return self

    def __exit__(self, *exc):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.seconds = time.perf_counter() - self._t0
        return False


@dataclass
class EWMA:
    """Exponentially-weighted moving average + variance (for straggler
    detection: flag samples > mean + k*std)."""

    alpha: float = 0.1
    mean: float = 0.0
    var: float = 0.0
    count: int = 0

    def update(self, x: float) -> None:
        if self.count == 0:
            self.mean = x
            self.var = 0.0
        else:
            delta = x - self.mean
            self.mean += self.alpha * delta
            self.var = (1 - self.alpha) * (self.var + self.alpha * delta * delta)
        self.count += 1

    @property
    def std(self) -> float:
        return self.var**0.5

    def is_outlier(self, x: float, k: float = 3.0, min_samples: int = 5) -> bool:
        if self.count < min_samples:
            return False
        return x > self.mean + k * max(self.std, 1e-9)
