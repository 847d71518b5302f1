"""Architecture registry of the port: ``--arch <id>`` resolution to the full
config and its reduced smoke-test variant. The port serves the dense family
(granite-8b) and the MoE family (olmoe-1b-7b)."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

_MODULES: Dict[str, str] = {
    "granite-8b": "repro_torch.configs.granite_8b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
}


def list_archs() -> List[str]:
    """Registered architecture ids."""
    return sorted(_MODULES)


def get_config(name: str) -> ModelConfig:
    """The full (published-width) config of an architecture."""
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; valid: {list_archs()}")
    return importlib.import_module(_MODULES[name]).FULL


def get_reduced(name: str) -> ModelConfig:
    """The reduced smoke-test config of an architecture."""
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; valid: {list_archs()}")
    return importlib.import_module(_MODULES[name]).reduced()


def preset_config(arch: str, preset: str) -> ModelConfig:
    """The config of ``--preset`` (the port's copy of ``repro``'s
    ``launch.train.preset_config``): ``full``, ``reduced``, or ``100m``, a
    ~100M-parameter member of the arch's family (8 layers, d_model 512,
    vocab 32768)."""
    if preset == "full":
        return get_config(arch)
    if preset == "reduced":
        return get_reduced(arch)
    if preset == "100m":
        base = get_reduced(arch)
        kw = dict(n_layers=8, d_model=512, d_ff=2048 if base.d_ff else 0, vocab_size=32768,
                  d_head=64)
        if base.n_heads:
            kw.update(n_heads=8, n_kv_heads=max(1, min(base.n_kv_heads, 8)))
        if base.n_experts:
            kw.update(n_experts=8, top_k=2, d_ff=1024)
        if base.ssm_state:
            kw.update(ssm_state=64, ssm_head_dim=64, ssm_chunk=64)
        if base.family == "encdec":
            kw.update(n_enc_layers=4, enc_frames=128)
        return dataclasses.replace(base, **kw)
    raise ValueError(f"unknown preset {preset}")
