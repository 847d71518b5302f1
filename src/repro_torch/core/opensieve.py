"""Open-sieve: the paper's per-policy Bloom-filter registry.

One Bloom filter per Stream-K++ policy (plus the DP baseline). A one-time
preprocessing step encodes the tuned winner for every benchmarked problem
size into the corresponding filter; at dispatch, querying all filters with
(M, N, K) prunes every policy whose filter answers "definitely absent" — the
paper measures up to ~95.8% of policy evaluations eliminated at a 100%
true-negative rate (inherent to Bloom filters).

The paper ships the filters as a generated C++ header (~1 byte per problem
size); ``encode_cpp_header`` reproduces that artifact and
``to_bytes``/``from_bytes`` provide the binary codec the framework itself
uses.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.arch import DEFAULT_ARCH
from repro_torch.core.bloom import BloomFilter
from repro_torch.core.op import GemmOp, encode_key
from repro_torch.core.policies import ALL_POLICIES, Policy, policy_from_name

MNK = Tuple[int, int, int]


def _as_key_bytes(key, arch: str = DEFAULT_ARCH) -> bytes:
    """Canonical filter bytes for any key form: raw bytes, a GemmOp, a bare
    (M, N, K), or an extended op-key tuple.

    Non-default arch classes prefix the class string so winners measured on
    different machine classes occupy disjoint filter keyspaces (a probe for
    one class never aliases another class's insertions beyond the ordinary
    Bloom fp rate). ``"default"``-class keys keep the legacy encoding, which
    is what keeps single-class sieve bytes identical to the pre-arch format.
    """
    if isinstance(key, bytes):
        kb = key
    elif isinstance(key, GemmOp):
        kb = key.encode()
    else:
        kb = encode_key(tuple(key))
    if arch != DEFAULT_ARCH:
        kb = arch.encode("utf-8") + b"\x00" + kb
    return kb


@dataclass
class QueryStats:
    """Counters backing the paper's elimination-rate claim."""

    queries: int = 0
    candidate_evals: int = 0  # policy evaluations NOT pruned
    pruned_evals: int = 0  # policy evaluations skipped thanks to the filters

    @property
    def elimination_rate(self) -> float:
        """Fraction of policy evaluations the filters pruned away."""
        tot = self.candidate_evals + self.pruned_evals
        return self.pruned_evals / tot if tot else 0.0


class OpenSieve:
    """Registry: policy name -> BloomFilter, with query bookkeeping.

    ``generation`` is the sieve's build version: Bloom filters cannot delete,
    so online adaptation never mutates a live sieve — it builds a fresh one
    from the grown database under ``generation + 1`` and hot-swaps it in
    (the old sieve keeps serving lookups until the swap, which is a single
    atomic reference assignment in the selector).
    """

    def __init__(
        self,
        policies: Sequence[Policy] = ALL_POLICIES,
        capacity: int = 10_000,
        fp_rate: float = 0.01,
        generation: int = 0,
    ):
        self.policies: Tuple[Policy, ...] = tuple(policies)
        self.generation = generation
        # Remembered so federation/gossip rebuilds inherit the worker's
        # installed geometry instead of silently re-deriving from defaults
        # (None after ``from_bytes`` — the wire format predates these).
        self.capacity: Optional[int] = capacity
        self.fp_rate: Optional[float] = fp_rate
        # One distinct hash family (seed) per filter — "7 distinct hash
        # functions, one for each filter" in the paper.
        self.filters: Dict[str, BloomFilter] = {
            p.name: BloomFilter.for_capacity(capacity, fp_rate, seed=i + 1)
            for i, p in enumerate(self.policies)
        }
        self.stats = QueryStats()

    # -- build ----------------------------------------------------------------
    def insert_winner(self, key, policy: Policy, arch: str = DEFAULT_ARCH) -> None:
        """``key``: (M, N, K), an extended op key, a GemmOp, or raw bytes."""
        if policy.name not in self.filters:
            raise KeyError(f"policy {policy.name} not registered")
        self.filters[policy.name].add(_as_key_bytes(key, arch))

    def build_from_winners(self, winners: Mapping, arch: str = DEFAULT_ARCH) -> "OpenSieve":
        """Bulk-insert a {key -> winning Policy} map; returns self."""
        for key, pol in winners.items():
            self.insert_winner(key, pol, arch=arch)
        return self

    # -- query ------------------------------------------------------------------
    def _query(self, key, arch: str = DEFAULT_ARCH) -> List[Policy]:
        """Uncounted filter probe (key forms as in :meth:`insert_winner`)."""
        kb = _as_key_bytes(key, arch)
        return [p for p in self.policies if kb in self.filters[p.name]]

    def candidates_any(self, *keys, arch: str = DEFAULT_ARCH) -> List[Policy]:
        """First non-empty candidate set across alternative key encodings
        for ONE dispatch (e.g. an op's exact fingerprint, then the
        dtype-agnostic legacy (M, N, K)). Accounted as a single
        consultation in ``QueryStats`` — the counters back the paper's
        elimination-rate claim, so one dispatch must count once however
        many key forms it probes."""
        out: List[Policy] = []
        for key in keys:
            out = self._query(key, arch)
            if out:
                break
        self.stats.queries += 1
        self.stats.candidate_evals += len(out)
        self.stats.pruned_evals += len(self.policies) - len(out)
        return out

    def candidates(self, key, arch: str = DEFAULT_ARCH) -> List[Policy]:
        """Policies whose filter answers "possibly present" for this key."""
        return self.candidates_any(key, arch=arch)

    def validate_true_negative_rate(self, winners: Mapping[MNK, Policy]) -> float:
        """Assert the Bloom contract on a winner map: the true winner is never
        pruned. Returns the measured TN rate over non-winner (size, policy)
        pairs (1.0 == every "absent" answer was correct; Bloom guarantees the
        converse direction, this checks our plumbing end-to-end)."""
        for size, pol in winners.items():
            key = _as_key_bytes(size)
            if key not in self.filters[pol.name]:
                raise AssertionError(
                    f"false negative for {size}/{pol.name} — Bloom contract broken"
                )
        # TN rate: of all negative answers, how many are genuinely negative.
        # By construction every negative is genuine (no false negatives), so
        # this is 1.0 unless plumbing is broken; we still measure it honestly.
        negatives = genuine = 0
        for size in winners:
            key = _as_key_bytes(size)
            for p in self.policies:
                if key not in self.filters[p.name]:
                    negatives += 1
                    if winners[size].name != p.name:
                        genuine += 1
        return genuine / negatives if negatives else 1.0

    # -- federation -----------------------------------------------------------
    def merge(
        self, other: "OpenSieve", generation: Optional[int] = None
    ) -> "OpenSieve":
        """Union of two sieves built over the SAME policy registry and
        filter parameterisation — the federated-merge path: N workers each
        encode their shard's winners, and the bitwise-OR union answers
        queries exactly like a sieve built from the merged winner map
        (inserting a key sets the same bits whichever worker's filter it
        lands in, so the union is bit-identical to the full rebuild).

        The result's ``generation`` defaults to ``max(ours, theirs) + 1`` —
        a merge is a new build version, so every
        :meth:`~repro_torch.core.selector.KernelSelector.hot_swap` consumer
        re-resolves against the union rather than trusting picks memoised
        under either input. Mismatched policy registries or filter
        parameters raise descriptively (see :meth:`BloomFilter.merge`)."""
        mine = {p.name for p in self.policies}
        theirs = {p.name for p in other.policies}
        if mine != theirs:
            raise ValueError(
                "cannot merge OpenSieves over different policy registries: "
                f"{sorted(mine)} vs {sorted(theirs)}"
            )
        out = OpenSieve.__new__(OpenSieve)
        out.policies = self.policies
        out.capacity = self.capacity
        out.fp_rate = self.fp_rate
        out.filters = {
            name: f.merge(other.filters[name]) for name, f in self.filters.items()
        }
        out.stats = QueryStats()
        out.generation = (
            generation
            if generation is not None
            else max(self.generation, other.generation) + 1
        )
        return out

    # -- codec ---------------------------------------------------------------
    def to_bytes(self) -> bytes:
        """Serialise all per-policy filters to the ``OSV1`` wire format."""
        blobs = [(name.encode(), f.to_bytes()) for name, f in self.filters.items()]
        out = [struct.pack("<4sI", b"OSV1", len(blobs))]
        for name, blob in blobs:
            out.append(struct.pack("<II", len(name), len(blob)))
            out.append(name)
            out.append(blob)
        return b"".join(out)

    @classmethod
    def from_bytes(cls, blob: bytes) -> "OpenSieve":
        """Inverse of :meth:`to_bytes` (generation restored separately)."""
        magic, n = struct.unpack_from("<4sI", blob)
        if magic != b"OSV1":
            raise ValueError("not an OpenSieve blob")
        off = 8
        filters: Dict[str, BloomFilter] = {}
        for _ in range(n):
            ln, lb = struct.unpack_from("<II", blob, off)
            off += 8
            name = blob[off : off + ln].decode()
            off += ln
            filters[name] = BloomFilter.from_bytes(blob[off : off + lb])
            off += lb
        sieve = cls.__new__(cls)
        sieve.policies = tuple(policy_from_name(n) for n in filters)
        sieve.filters = filters
        sieve.stats = QueryStats()
        sieve.generation = 0
        # The OSV1 wire format predates geometry bookkeeping; bit/hash
        # counts survive in the filters themselves, the nominal knobs don't.
        sieve.capacity = None
        sieve.fp_rate = None
        return sieve

    def encode_cpp_header(self) -> str:
        """The paper's artifact: a compact generated C++ header embedding the
        filters (~1 byte of information per problem size once amortised)."""
        lines = [
            "// Auto-generated by Open-sieve (Stream-K++ reproduction).",
            "#pragma once",
            "#include <cstdint>",
            "namespace opensieve {",
        ]
        for name, f in self.filters.items():
            arr = ",".join(str(b) for b in f.bits.tobytes())
            lines += [
                f"inline constexpr uint32_t {name}_n_bits = {f.n_bits};",
                f"inline constexpr uint32_t {name}_n_hashes = {f.n_hashes};",
                f"inline constexpr uint32_t {name}_seed = {f.seed};",
                f"inline constexpr uint8_t {name}_bits[] = {{{arr}}};",
            ]
        lines.append("}  // namespace opensieve")
        return "\n".join(lines)

    # -- info -----------------------------------------------------------------
    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-filter occupancy stats. ``n_items`` is the raw add-counter —
        after ``BloomFilter.merge`` it is only an upper bound on distinct
        keys — so capacity planning reads the saturation-derived
        ``est_items`` instead."""
        return {
            name: {
                "n_items": f.n_items,
                "est_items": f.est_items,
                "n_bits": f.n_bits,
                "n_hashes": f.n_hashes,
                "saturation": f.saturation,
                "est_fp_rate": f.est_fp_rate,
            }
            for name, f in self.filters.items()
        }
