"""The paper's FP16 GEMM benchmark suite (the port's copy of
``repro.configs.gemm_suite``): 923 unique problem sizes with
dimensions in powers of two, M in [1, 8192], N in [64, 8192],
K in [16, 65536] (§5.1).

The full power-of-two grid is 14 x 8 x 13 = 1456 cells; the paper
benchmarks 923 of them (their industry-informed subset is confidential).
We down-select deterministically to exactly 923 by keeping the cells with
the smallest working sets (A + B + C footprint) — i.e. dropping the sizes
that would not have fit the benchmarking budget of an MI250X-era device —
so the suite is reproducible from this file alone.
"""

from __future__ import annotations

from typing import List, Tuple

MNK = Tuple[int, int, int]

N_SIZES = 923


def full_grid() -> List[MNK]:
    """Every power-of-two (M, N, K) cell of the paper's ranges (1456)."""
    ms = [2**i for i in range(0, 14)]  # 1 .. 8192
    ns = [2**i for i in range(6, 14)]  # 64 .. 8192
    ks = [2**i for i in range(4, 17)]  # 16 .. 65536
    return [(m, n, k) for m in ms for n in ns for k in ks]


def working_set_bytes(size: MNK, dtype_bytes: int = 2) -> int:
    """A + B + C footprint of one size at ``dtype_bytes`` per element."""
    m, n, k = size
    return (m * k + k * n + m * n) * dtype_bytes


def suite(n: int = N_SIZES) -> List[MNK]:
    """The 923-size benchmark suite (deterministic)."""
    grid = full_grid()
    # stable sort by working set, then lexicographic for determinism
    grid.sort(key=lambda s: (working_set_bytes(s), s))
    return sorted(grid[:n])
