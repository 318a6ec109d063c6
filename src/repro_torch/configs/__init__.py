"""Architecture registry: ``get_config("<arch-id>")``.

A copy of the JAX package's ``repro.configs`` (``base.py`` and the ten
published configurations are data only), without ``input_specs``, which
comes with the dry-run tooling.
"""
from __future__ import annotations

import importlib

from .base import SHAPES, ModelConfig, ShapeSpec, applicable_shapes

_MODULES = {
    "granite-moe-1b-a400m": ".granite_moe_1b_a400m",
    "deepseek-v2-lite-16b": ".deepseek_v2_lite_16b",
    "qwen2-vl-72b": ".qwen2_vl_72b",
    "command-r-35b": ".command_r_35b",
    "qwen1.5-4b": ".qwen15_4b",
    "mistral-nemo-12b": ".mistral_nemo_12b",
    "nemotron-4-15b": ".nemotron_4_15b",
    "zamba2-1.2b": ".zamba2_1p2b",
    "xlstm-1.3b": ".xlstm_1p3b",
    "whisper-tiny": ".whisper_tiny",
}

ARCH_IDS = list(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    try:
        mod = importlib.import_module(_MODULES[arch_id], __package__)
    except KeyError:
        raise ValueError(f"unknown arch {arch_id!r}; one of {ARCH_IDS}") \
            from None
    return mod.ARCH


__all__ = ["ARCH_IDS", "get_config", "ModelConfig", "ShapeSpec", "SHAPES",
           "applicable_shapes"]
