"""Bloom filters over GEMM problem sizes (the paper's Open-sieve core).

The paper uses the mmh3 MurmurHash3 implementation to key (M, N, K) into
per-policy Bloom filters sized for 10,000 problem sizes each. mmh3 is not
installed in this container, so ``murmur3_32`` below is a from-scratch,
bit-exact reimplementation of MurmurHash3_x86_32 (validated against the
published reference vectors in tests). Filters use the standard Kirsch-
Mitzenmacher double-hashing scheme h_i = h1 + i*h2 so two murmur calls give
all k probes.

Bloom-filter contract exploited by the paper: NO false negatives ("100% true
negative rate") — if a filter answers "absent", the policy is definitely not
a tuned winner for that size and its evaluation can be skipped; false
positives only cost a redundant evaluation, never a wrong kernel result.
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass
from typing import Iterable, Tuple

import numpy as np

_U32 = 0xFFFFFFFF


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _U32


def murmur3_32(data: bytes, seed: int = 0) -> int:
    """MurmurHash3_x86_32, bit-exact vs. the canonical C++/mmh3 (unsigned)."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed & _U32
    n_blocks = len(data) // 4
    for i in range(n_blocks):
        k = struct.unpack_from("<I", data, i * 4)[0]
        k = (k * c1) & _U32
        k = _rotl32(k, 15)
        k = (k * c2) & _U32
        h ^= k
        h = _rotl32(h, 13)
        h = (h * 5 + 0xE6546B64) & _U32
    # tail
    tail = data[n_blocks * 4 :]
    k = 0
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * c1) & _U32
        k = _rotl32(k, 15)
        k = (k * c2) & _U32
        h ^= k
    # finalization
    h ^= len(data)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _U32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _U32
    h ^= h >> 16
    return h


def encode_mnk(m: int, n: int, k: int) -> bytes:
    """Canonical little-endian key for a GEMM problem size."""
    return struct.pack("<3q", m, n, k)


def optimal_params(capacity: int, fp_rate: float) -> Tuple[int, int]:
    """(n_bits, n_hashes) for a target capacity and false-positive rate."""
    if capacity < 1 or not (0.0 < fp_rate < 1.0):
        raise ValueError("bad bloom parameters")
    n_bits = math.ceil(-capacity * math.log(fp_rate) / (math.log(2) ** 2))
    n_bits = max(64, n_bits)
    n_hashes = max(1, round((n_bits / capacity) * math.log(2)))
    return n_bits, n_hashes


@dataclass
class BloomFilter:
    """Fixed-size Bloom filter backed by a numpy uint8 bit array.

    ``seed`` makes each policy's filter an independent hash family — the
    paper's "7 distinct hash functions, one for each filter".
    """

    n_bits: int
    n_hashes: int
    seed: int = 0

    def __post_init__(self):
        if self.n_bits % 8:
            self.n_bits += 8 - self.n_bits % 8
        self.bits = np.zeros(self.n_bits // 8, dtype=np.uint8)
        self.n_items = 0

    @classmethod
    def for_capacity(cls, capacity: int = 10_000, fp_rate: float = 0.01, seed: int = 0):
        """Size a filter for ``capacity`` keys at a target FP rate."""
        n_bits, n_hashes = optimal_params(capacity, fp_rate)
        return cls(n_bits=n_bits, n_hashes=n_hashes, seed=seed)

    # -- probe schedule ----------------------------------------------------
    def _probes(self, key: bytes) -> Iterable[int]:
        h1 = murmur3_32(key, self.seed)
        h2 = murmur3_32(key, h1 ^ 0x9747B28C) | 1  # odd => full-cycle stride
        for i in range(self.n_hashes):
            # uint32 wraparound BEFORE the modulo: keeps the probe schedule
            # bit-identical to the C++/jnp uint32 implementations
            yield ((h1 + i * h2) & _U32) % self.n_bits

    # -- set ops -------------------------------------------------------------
    def add(self, key: bytes) -> None:
        """Insert a raw key (sets ``n_hashes`` bits; never fails)."""
        for p in self._probes(key):
            self.bits[p >> 3] |= 1 << (p & 7)
        self.n_items += 1

    def __contains__(self, key: bytes) -> bool:
        return all(self.bits[p >> 3] & (1 << (p & 7)) for p in self._probes(key))

    def add_mnk(self, m: int, n: int, k: int) -> None:
        """Insert a GEMM problem size under its canonical byte key."""
        self.add(encode_mnk(m, n, k))

    def query_mnk(self, m: int, n: int, k: int) -> bool:
        """Probe a GEMM problem size (True == "possibly present")."""
        return encode_mnk(m, n, k) in self

    # -- stats / codec ---------------------------------------------------------
    @property
    def saturation(self) -> float:
        """Fraction of set bits (FP rate ~= saturation ** n_hashes)."""
        return float(np.unpackbits(self.bits).mean())

    @property
    def est_items(self) -> float:
        """Distinct-key estimate from the bit saturation — the standard
        ``-(m/k) * ln(1 - X/m)`` Bloom cardinality estimator. Unlike
        ``n_items`` (an add-counter that double-counts duplicates, and after
        ``merge`` only an upper bound) this is dedupe-aware, so capacity
        planning should read this, not ``n_items``."""
        sat = self.saturation
        if sat >= 1.0:
            return float("inf")
        return -(self.n_bits / self.n_hashes) * math.log(1.0 - sat)

    @property
    def est_fp_rate(self) -> float:
        """Current false-positive probability estimate (saturation^k)."""
        return self.saturation**self.n_hashes

    def to_bytes(self) -> bytes:
        """Serialise to the versioned ``BLM1`` wire format."""
        head = struct.pack("<4sIIII", b"BLM1", self.n_bits, self.n_hashes, self.seed, self.n_items)
        return head + self.bits.tobytes()

    @classmethod
    def from_bytes(cls, blob: bytes) -> "BloomFilter":
        """Inverse of :meth:`to_bytes`; validates magic and payload length."""
        magic, n_bits, n_hashes, seed, n_items = struct.unpack_from("<4sIIII", blob)
        if magic != b"BLM1":
            raise ValueError("not a serialized BloomFilter")
        f = cls(n_bits=n_bits, n_hashes=n_hashes, seed=seed)
        if len(blob) - 20 != f.n_bits // 8:
            # a truncated blob would otherwise produce a filter whose bit
            # array is shorter than n_bits claims — every probe past the end
            # then raises IndexError, and merge would silently mis-combine
            raise ValueError(
                f"BloomFilter blob payload is {len(blob) - 20} bytes but "
                f"n_bits={f.n_bits} requires {f.n_bits // 8}"
            )
        f.bits = np.frombuffer(blob[20:], dtype=np.uint8).copy()
        f.n_items = n_items
        return f

    def params_str(self) -> str:
        """Human-readable parameter fingerprint (for mismatch diagnostics)."""
        return (
            f"BloomFilter(n_bits={self.n_bits}, n_hashes={self.n_hashes}, "
            f"seed={self.seed})"
        )

    def merge(self, other: "BloomFilter") -> "BloomFilter":
        """Bitwise-OR union of two filters over the SAME parameterisation.

        Filters are only unionable when n_bits, n_hashes, and seed all match
        — otherwise the probe schedules differ and the OR would answer
        "possibly present" for keys neither filter ever saw *and* lose the
        no-false-negative contract. Mismatches raise up front with both
        configurations named (a silent shape-broadcast or an IndexError deep
        in a later query is how this used to surface)."""
        if (self.n_bits, self.n_hashes, self.seed) != (
            other.n_bits,
            other.n_hashes,
            other.seed,
        ):
            raise ValueError(
                "cannot merge BloomFilters with mismatched parameters: "
                f"{self.params_str()} vs {other.params_str()}"
            )
        if self.bits.shape != other.bits.shape:
            raise ValueError(
                "cannot merge BloomFilters with mismatched bit arrays: "
                f"{self.bits.shape[0]} vs {other.bits.shape[0]} bytes "
                f"(both claim n_bits={self.n_bits})"
            )
        out = BloomFilter(self.n_bits, self.n_hashes, self.seed)
        out.bits = self.bits | other.bits
        # The merge is dedupe-agnostic (bitwise OR cannot tell how many keys
        # the two filters shared), so the summed count is only an UPPER
        # bound on distinct keys — overlapping key sets double-count. Read
        # ``est_items`` (saturation-based) for occupancy/capacity planning.
        out.n_items = self.n_items + other.n_items
        return out
