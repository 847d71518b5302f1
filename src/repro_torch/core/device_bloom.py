"""Batched Bloom-filter queries on torch tensors (the port's counterpart of
``repro.core.jax_bloom``).

:class:`~repro_torch.core.bloom.BloomFilter` is the build-time artifact; at
dispatch time a batch of (M, N, K) keys — thousands of them — can be asked
on the card in one vectorised pass. This module is MurmurHash3_x86_32 over
the canonical 24-byte ``<3q`` key encoding (six little-endian uint32 words,
fixed length, so the block loop unrolls and there is no tail), then the
filter's double-hashing probes, bit-exact with ``core/bloom.py``.

torch's ``uint32`` lacks the products, so every word is held in an
``int64`` and masked to 32 bits after each step; a product multiplies by
the constant's 16-bit halves, each below 2**48, so ``int64`` holds it
exactly. It is plain torch on purpose: ``repro``'s version is plain
``jnp``, not a Pallas kernel.
"""

from __future__ import annotations

from typing import Sequence

import torch

_MASK = 0xFFFFFFFF
_C1 = 0xCC9E2D51
_C2 = 0x1B873593


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x & _MASK


def _mul(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c`` mod 2**32 for a 32-bit ``x`` and ``c`` (module doc)."""
    lo, hi = c & 0xFFFF, c >> 16
    return _u32(x * lo + _u32(x * hi) * 65536)


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return _u32(x << r) | (x >> (32 - r))


def _mix(h: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    k = _mul(k, _C1)
    k = _rotl32(k, 15)
    k = _mul(k, _C2)
    h = h ^ k
    h = _rotl32(h, 13)
    return _u32(_mul(h, 5) + 0xE6546B64)


def murmur3_32_words(words: torch.Tensor, seed) -> torch.Tensor:
    """MurmurHash3_x86_32 of each row of ``words`` (int64 [..., W], each a
    little-endian uint32 word of a W*4-byte key); ``seed``: an int or an
    int64 tensor broadcastable to ``words[..., 0]``. Returns int64 [...]
    holding uint32 values."""
    words = _u32(words.to(torch.int64))
    seed = torch.as_tensor(seed, dtype=torch.int64, device=words.device)
    h = _u32(torch.broadcast_to(seed, words.shape[:-1]).clone())
    w = words.shape[-1]
    for i in range(w):
        h = _mix(h, words[..., i])
    h = h ^ (w * 4)
    h = h ^ (h >> 16)
    h = _mul(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def mnk_to_words(m, n, k, device=None) -> torch.Tensor:
    """Integer tensors (or sequences) of problem sizes -> int64 [..., 6]
    words matching ``struct.pack('<3q', m, n, k)``: GEMM dims are < 2**31,
    so the high word of each little-endian int64 is zero."""
    m, n, k = (torch.as_tensor(v, dtype=torch.int64, device=device) for v in (m, n, k))
    m, n, k = torch.broadcast_tensors(m, n, k)
    zero = torch.zeros_like(m)
    return torch.stack([_u32(m), zero, _u32(n), zero, _u32(k), zero], dim=-1)


def _probe(h1: torch.Tensor, h2: torch.Tensor, i: int, n_bits: int) -> torch.Tensor:
    """The ``i``-th double-hashing probe: ``(h1 + i * h2) mod 2**32 mod n_bits``."""
    return torch.remainder(_u32(h1 + _u32(h2 * i)), n_bits)


def bloom_query(bits_u8, n_bits: int, n_hashes: int, seed: int, m, n, k) -> torch.Tensor:
    """Vectorised membership query of the packed filter ``bits_u8`` (uint8
    [n_bits // 8], ``BloomFilter.bits``; bytes, numpy or a tensor, moved to
    the device of ``m``) for the keys (m, n, k): a bool tensor, True for
    "possibly present", False for "definitely absent"."""
    m = torch.as_tensor(m)
    words = mnk_to_words(m, n, k, device=m.device)
    h1 = murmur3_32_words(words, int(seed))
    h2 = murmur3_32_words(words, h1 ^ 0x9747B28C) | 1
    bits = torch.as_tensor(bytearray(bits_u8) if isinstance(bits_u8, (bytes, bytearray))
                           else bits_u8, dtype=torch.uint8).to(words.device)
    hit = torch.ones(h1.shape, dtype=torch.bool, device=words.device)
    for i in range(n_hashes):
        p = _probe(h1, h2, i, n_bits)
        byte = bits[(p >> 3)].to(torch.int64)
        hit &= ((byte >> (p & 7)) & 1) == 1
    return hit


def query_filters(filters: Sequence, m, n, k) -> torch.Tensor:
    """Query a list of :class:`~repro_torch.core.bloom.BloomFilter`;
    returns bool [..., n_filters]."""
    return torch.stack([bloom_query(f.bits, f.n_bits, f.n_hashes, f.seed, m, n, k)
                        for f in filters], dim=-1)
