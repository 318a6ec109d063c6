"""Architecture registry: ``get_config("<arch-id>")`` + ``input_specs``.

A copy of the JAX package's ``repro.configs`` (``base.py`` and the ten
published configurations are data only).  ``input_specs`` gives every
model input of a cell as ``meta`` tensors, the counterpart of the
reference's ``ShapeDtypeStruct`` stand-ins; it imports the model API
only when called, so the registry stays data only at import.
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


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """Stand-ins for every model input of a cell, tensors on the ``meta``
    device (shapes and dtypes, nothing allocated):

    * train/prefill -> {"batch": {"tokens", modality stubs...}}
    * decode        -> {"token", "caches", "pos"}
    """
    import torch

    from ..data.pipeline import make_batch_specs
    from ..models import api

    spec = SHAPES[shape_name]
    b, s = spec.global_batch, spec.seq_len
    if spec.kind in ("train", "prefill"):
        return {"batch": make_batch_specs(cfg, s, b)}
    # decode: one new token against a seq_len cache
    return {
        "token": torch.empty((b, 1), dtype=torch.int32, device="meta"),
        "caches": api.init_cache(cfg, b, s, device="meta"),
        "pos": torch.empty((), dtype=torch.int32, device="meta"),
    }


__all__ = ["ARCH_IDS", "get_config", "input_specs", "ModelConfig",
           "ShapeSpec", "SHAPES", "applicable_shapes"]
