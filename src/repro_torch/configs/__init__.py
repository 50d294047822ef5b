"""Architecture registry of the port: the JAX package's ten archs by name.

``get(name)`` returns the FULL config, ``get_smoke(name)`` the reduced
same-family one, as ``repro.configs`` does; each module is a copy of
``src/repro/configs/<arch>.py``.  The port builds every one of them:
dense and MoE attention stacks, the Mamba-2 / shared-attention hybrid,
xLSTM, the ``embed_stub`` audio frontend and the cross-attention
vision stack.
"""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

ARCHS: List[str] = [
    "xlstm_350m",
    "qwen3_moe_235b_a22b",
    "llama4_maverick_400b_a17b",
    "phi4_mini_3_8b",
    "granite_3_8b",
    "starcoder2_15b",
    "nemotron_4_15b",
    "musicgen_large",
    "llama_3_2_vision_90b",
    "zamba2_1_2b",
]


def _canon(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def _module(name: str):
    name = _canon(name)
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; one of {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get(name: str) -> ModelConfig:
    return _module(name).FULL


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE


def all_archs() -> List[str]:
    return list(ARCHS)
