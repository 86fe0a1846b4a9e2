"""Architecture registry of the port: ``get_config(arch)`` resolves here.

Each module exports ``CONFIG`` (the published configuration) and
``SMOKE`` (a reduced same-family config for CPU tests), copies of the
JAX package's ``repro.configs`` modules.  Only the families whose layers
the port builds are registered; any other name raises ``KeyError`` as
``repro``'s registry does for an unknown arch.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

_MODULES: Dict[str, str] = {
    "gemma3-1b": "gemma3_1b",
    "jamba-v0.1-52b": "jamba_v0p1_52b",
    "xlstm-1.3b": "xlstm_1p3b",
}


def list_archs() -> List[str]:
    return sorted(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG.validate()


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE.validate()
