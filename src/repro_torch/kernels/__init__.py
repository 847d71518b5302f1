"""Hand-written Hopper GEMM kernels (``csrc/``) with their wrappers,
plain PyTorch versions and launch counters."""
