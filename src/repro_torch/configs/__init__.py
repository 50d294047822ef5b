"""Architecture registry of the port: the JAX package's ten archs by name.

``get(name)`` returns the FULL config, ``get_smoke(name)`` the reduced
same-family one, as ``repro.configs`` does.  The port runs the four
dense attention-only archs; the other six need a mixer or a frontend it
does not have yet, and ``get`` / ``get_smoke`` raise for them, naming
the ROADMAP item that ports it.
"""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import ROADMAP_OTHER_MIXERS

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

PORTED: List[str] = ["phi4_mini_3_8b", "granite_3_8b", "starcoder2_15b",
                     "nemotron_4_15b"]

_NEEDS = {
    "xlstm_350m": "the mLSTM / sLSTM mixers",
    "qwen3_moe_235b_a22b": "the MoE FFN",
    "llama4_maverick_400b_a17b": "the MoE FFN",
    "musicgen_large": "the embed_stub frontend",
    "llama_3_2_vision_90b": "cross-attention",
    "zamba2_1_2b": "the Mamba-2 mixer and shared_attn",
}


def _canon(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def _module(name: str):
    name = _canon(name)
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; one of {ARCHS}")
    if name not in PORTED:
        raise NotImplementedError(
            f"{name} needs {_NEEDS[name]}, which the port does not have "
            f"yet.  See {ROADMAP_OTHER_MIXERS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get(name: str) -> ModelConfig:
    return _module(name).FULL


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE


def all_archs() -> List[str]:
    return list(ARCHS)
