"""Architecture registry of the port: ``--arch <id>`` resolution to the full
config and its reduced smoke-test variant. The port serves the dense family
(granite-8b) and the MoE family (olmoe-1b-7b)."""

from __future__ import annotations

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
