"""Kernel B1: the data-parallel GEMM region."""
