"""Architecture registry of the port: ``--arch <id>`` resolves here.

Each module exports ``CONFIG`` (the published configuration) and
``SMOKE`` (a reduced same-family config for CPU tests: same pattern,
mixer mix and modality, tiny dims), copies of the JAX package's
``repro.configs`` modules; all ten of its architectures are registered.
An unknown name raises ``KeyError``.  ``get_shape`` and ``cells`` give the
assigned input-shape cells, as ``repro``'s registry does.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig

_MODULES: Dict[str, str] = {
    "xlstm-1.3b": "xlstm_1p3b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2p7b",
    "minitron-8b": "minitron_8b",
    "gemma3-27b": "gemma3_27b",
    "gemma3-1b": "gemma3_1b",
    "mistral-large-123b": "mistral_large_123b",
    "jamba-v0.1-52b": "jamba_v0p1_52b",
    "musicgen-large": "musicgen_large",
    "qwen2-vl-72b": "qwen2_vl_72b",
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


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cells(arch: str) -> List[str]:
    """The assigned shape cells of one arch: long_500k only where
    ``long_context_ok`` (every arch here is a decoder, so the decode
    shapes run)."""
    cfg = get_config(arch)
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.long_context_ok:
        names.append("long_500k")
    return names
