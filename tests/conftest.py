import os
import sys

# Tests run on the host's real device count (1 CPU device) — the 512-device
# forcing is dryrun.py-only. Subprocess-based tests set their own XLA_FLAGS.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import dataclasses

import jax
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the port's Hopper kernels); skips without one"
    )


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def tiny(arch: str, **overrides):
    """Reduced config, f32 for exact comparisons."""
    from repro.configs import get_reduced

    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def make_batch(cfg, b=2, s=16, seed=0):
    import jax.numpy as jnp

    r = np.random.default_rng(seed)
    batch = {
        "tokens": jnp.asarray(r.integers(0, cfg.vocab_size, (b, s))),
        "labels": jnp.asarray(r.integers(0, cfg.vocab_size, (b, s))),
    }
    if cfg.family == "vlm":
        batch["patch_embeds"] = jnp.asarray(
            r.normal(size=(b, cfg.n_patches, cfg.d_model)), jnp.float32
        )
    if cfg.family == "encdec":
        batch["frames"] = jnp.asarray(
            r.normal(size=(b, cfg.enc_frames, cfg.d_model)), jnp.float32
        )
    return batch
