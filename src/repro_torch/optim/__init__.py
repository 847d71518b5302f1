"""Optimizers and learning-rate schedules (``repro.optim``'s counterparts)."""

from repro_torch.optim.optimizers import AdamW, Adafactor, SGD, clip_by_global_norm, make_optimizer
from repro_torch.optim.schedules import constant, warmup_cosine, warmup_linear

__all__ = [
    "AdamW",
    "Adafactor",
    "SGD",
    "clip_by_global_norm",
    "make_optimizer",
    "constant",
    "warmup_cosine",
    "warmup_linear",
]
