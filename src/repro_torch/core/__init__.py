"""Selection substrate and GEMM dispatch of the port (jax-free copies of
``repro.core`` modules, with torch where the JAX package used jnp)."""
