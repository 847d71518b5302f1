"""Guards of the port: it never imports jax or the JAX package, its entry
points refuse to fall back to the CPU on their own, and its CUDA wrappers
refuse what their kernels do not take."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.core.gemm import gemm_context
from repro_torch.core.policies import ALL_SK, TileConfig
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.streamk import ops
from repro_torch.models.lm import LM, resolve_device
from repro_torch.serve.engine import ServeConfig, ServeEngine

ROOT = Path(__file__).resolve().parent.parent
#: the port, the chip smoke run, the kernel A/B timer, the logits and SASS
#: probes and the card-only tests (they run where jax is not installed)
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "kernel_ab.py", ROOT / "logits_probe.py",
    ROOT / "sass_ab.py", ROOT / "tests" / "test_torch_cuda.py"]
FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_torch)|from\s+(jax|repro)(\.|\s)(?!_torch))")


def test_port_import_leaves_jax_out():
    """A subprocess, because this test process already imported jax."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import repro_torch, repro_torch.launch.serve, repro_torch.kernels.streamk.ops, "
            "repro_torch.kernels.streamk.grouped, repro_torch.core.quant, "
            "repro_torch.kernels.splitk.ops, repro_torch.kernels.dp.ops, "
            "repro_torch.launch.tune, repro_torch.core.tuner, repro_torch.core.calibrate, "
            "repro_torch.core.adaptive, repro_torch.configs.gemm_suite, "
            "repro_torch.utils.logging, repro_torch.serve.paged_kv, "
            "repro_torch.serve.scheduler, repro_torch.core.federate, "
            "repro_torch.core.gossip, sys; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not [m for m in sys.modules if m == 'repro' or m.startswith('repro.')]")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports_in_port_sources(path):
    assert path.exists()
    bad = [line for line in path.read_text().splitlines() if FORBIDDEN.match(line)]
    assert not bad, bad


def test_forbidden_pattern_catches_what_it_should():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                 "from repro.core import gemm", "  import repro"):
        assert FORBIDDEN.match(line), line
    for line in ("import repro_torch", "from repro_torch.core import gemm", "import jaxlib_x"):
        assert not FORBIDDEN.match(line), line


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def test_entry_points_refuse_to_fall_back_to_cpu(no_cuda):
    model = LM(get_reduced("granite-8b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_params()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_cache(1, 8)
    params = model.init_params(device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(model, params, ServeConfig(n_slots=1, max_seq=8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with gemm_context(backend="cuda"):
            pass
    with gemm_context(backend="cuda", device="cpu"):
        pass


def test_kernel_build_needs_nvcc_and_never_runs_at_import(no_cuda, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(cuda_lib, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_lib.library()


def test_cuda_wrappers_refuse_cpu_tensors_they_cannot_take():
    from repro_torch.kernels.common import check_cuda_operands

    a, b = torch.ones(4, 8), torch.ones(8, 16)
    with pytest.raises(ValueError, match="CUDA device"):
        check_cuda_operands(a, b, torch.float32, None, None)
    # int8 x int4 is taken now: on CPU tensors it runs the plain versions
    got = ops.gemm(a.to(torch.int8), b[:4].to(torch.int8), policy=ALL_SK,
                   cfg=TileConfig(8, 128, 128), g=4, b_bits=4, out_dtype=torch.float32)
    assert torch.equal(got, torch.full((4, 16), 4.0))  # byte 1: k even 1, k odd 0


@pytest.mark.parametrize("wrapper", ["splitk.ops.gemm", "splitk_partials", "dp.ops.gemm",
                                     "streamk.ops.gemm"])
def test_wrappers_never_fall_back_to_the_plain_version_off_the_cpu(wrapper):
    """Only a CPU tensor takes the plain version: any other tensor goes to
    the kernel path, which raises where it cannot launch (here: a tensor on
    the meta device, which is not a CUDA device, and no build)."""
    from repro_torch.kernels.dp import ops as dp_ops
    from repro_torch.kernels.splitk import ops as splitk_ops
    from repro_torch.kernels.splitk import splitk_partials

    a, b = torch.ones(4, 256, device="meta"), torch.ones(256, 128, device="meta")
    cfg = TileConfig(8, 128, 128)
    call = {"splitk.ops.gemm": lambda: splitk_ops.gemm(a, b, cfg=cfg, s=2),
            "splitk_partials": lambda: splitk_partials(a, b, cfg, 2),
            "dp.ops.gemm": lambda: dp_ops.gemm(a, b, cfg=cfg),
            "streamk.ops.gemm": lambda: ops.gemm(a, b, policy=ALL_SK, cfg=cfg, g=4)}[wrapper]
    with pytest.raises(ValueError, match="CUDA device"):
        call()


def test_full_granite_config_is_the_published_width():
    cfg = get_config("granite-8b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size) == (
        36, 4096, 32, 8, 14336, 49152)
    assert cfg.dtype == "bfloat16" and cfg.mlp_act == "swiglu"
