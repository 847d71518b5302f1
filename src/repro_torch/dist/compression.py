"""Gradient compression with error feedback (the port's copy of
``repro.dist.compression``; 1-bit-Adam-style residuals).

``quantize_int8`` is per-tensor symmetric int8: the communicated payload is
1/4 the f32 bytes (+ one scale). ``ErrorFeedback`` keeps the quantisation
residual locally and re-adds it before the next step's compression, so the
*accumulated* applied update converges to the accumulated true gradient.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.utils.trees import tree_map


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric quantisation: returns (int8 values, f32 scale);
    rounds half to even, as ``jnp.round``."""
    xf = x.to(torch.float32)
    amax = torch.max(torch.abs(xf))
    scale = torch.clamp_min(amax, 1e-30) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_decompress(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantise-dequantise roundtrip; returns (xhat, residual = x - xhat)."""
    q, scale = quantize_int8(x)
    xhat = q.to(torch.float32) * scale
    return xhat.to(x.dtype), (x.to(torch.float32) - xhat).to(x.dtype)


class ErrorFeedback:
    """Tree-level error-feedback state helpers (residual per parameter)."""

    @staticmethod
    def init(params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                        params)

    @staticmethod
    def apply(grads, residuals):
        """Compress ``grads + residuals``; returns (ghat, new_residuals)."""
        pairs = tree_map(lambda g, r: compress_decompress(g.to(torch.float32) + r), grads,
                         residuals)
        ghat = tree_map(lambda _, t: t[0], grads, pairs)
        res = tree_map(lambda _, t: t[1], grads, pairs)
        return ghat, res
