"""Architecture registry: ``get_config(name)`` / ``ARCHS`` (plain data)."""
from __future__ import annotations

import importlib

from repro_torch.configs.common import (SHAPES, ShapeCell, cell_applicable,
                                        input_specs, smoke_shrink)

_MODULES = {
    "command-r-35b": "command_r_35b",
    "qwen2-72b": "qwen2_72b",
    "starcoder2-7b": "starcoder2_7b",
    "qwen2.5-3b": "qwen2p5_3b",
    "mixtral-8x22b": "mixtral_8x22b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "whisper-large-v3": "whisper_large_v3",
    "xlstm-350m": "xlstm_350m",
    "phi-3-vision-4.2b": "phi3_vision_4p2b",
    "zamba2-1.2b": "zamba2_1p2b",
    "cody-mnist": "cody_mnist",
}

ARCHS = tuple(k for k in _MODULES if k != "cody-mnist")


def get_config(name: str):
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


__all__ = ["ARCHS", "get_config", "SHAPES", "ShapeCell", "cell_applicable",
           "input_specs", "smoke_shrink"]
