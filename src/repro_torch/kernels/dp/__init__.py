"""Kernel B1: the data-parallel GEMM region, and the DP baseline family."""
