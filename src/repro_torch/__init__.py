"""PyTorch + CUDA port of the Stream-K++ reproduction for one NVIDIA H100.

Sits beside the JAX package ``repro`` (the reference, untouched) and mirrors
its module names: ``repro_torch.core`` holds the jax-free selection substrate
(policies, partitions, op fingerprints, Bloom sieve, cost model, selector,
dispatch), ``repro_torch.kernels`` the hand-written Hopper kernels with their
plain PyTorch versions, and ``repro_torch.models``/``serve``/``launch`` the
dense and MoE LMs (sliding windows and ring caches, tied heads) that serve
through them. Importing the package imports torch and
numpy only — never jax, never ``repro``.
"""
