"""Assigned input shapes and their shape-and-dtype stand-ins (PyTorch port
of ``repro.configs.shapes``).

Five shapes per LM architecture:
  train_4k     seq 4,096   global_batch 256   -> train step
  prefill_32k  seq 32,768  global_batch 32    -> prefill (inference)
  decode_32k   seq 32,768  global_batch 128   -> serve step (1 new token,
                                                 KV cache of seq_len)
  long_500k    seq 524,288 global_batch 1     -> serve step; needs
                                                 sub-quadratic attention,
                                                 run only for SSM / hybrid
                                                 archs
                                                 (cfg.supports_long_context)
  vocab_large  seq 4,096   global_batch 64    -> serve step with the arch's
                                                 vocab OVERRIDDEN to 131,072
                                                 (a production LM's vocab):
                                                 the dry-run and roofline
                                                 cell where the O(V·d) head
                                                 dominates the decode bytes

A ``ShapeSpec.vocab`` override applies only on the abstract-evaluation
paths (``launch.dryrun.run_cell`` and ``launch.roofline``).

The stand-ins are ``TensorSpec(shape, dtype)``.  ``batch_specs`` has the
reference's keys and shapes; ``cache_specs`` is in the PORT's cache
layout, one entry a layer (``models.lm.LM.init_cache``): ``{"k", "v",
"len"}`` with k/v (B, S_max, Hkv, D) for every attention kind (each
shared_attn occurrence its own), ``{"state": ...}`` for a mixer, where
the reference stacks each pattern position's layers into
(R, B, S, Hkv, D) leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import ATTN_KINDS


class TensorSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str     # "train" | "prefill" | "decode"
    # when set, the cell runs with cfg.vocab overridden (dry run and
    # roofline only: see apply_vocab)
    vocab: Optional[int] = None


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
    "vocab_large": ShapeSpec("vocab_large", 4_096, 64, "decode",
                             vocab=131_072),
}


def apply_vocab(cfg: ModelConfig, shape: ShapeSpec) -> ModelConfig:
    """The config the cell actually runs: vocab overridden when the shape
    pins one (vocab_large), unchanged otherwise."""
    if shape.vocab is None or shape.vocab == cfg.vocab:
        return cfg
    return dataclasses.replace(cfg, vocab=shape.vocab)


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    """None if the (arch, shape) cell runs; else the skip reason."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return ("pure full-attention arch: 500k-token context is "
                "quadratic-prefill/O(seq) KV-cache territory reserved for "
                "sub-quadratic mixers per the assignment (see DESIGN.md)")
    return None


def _f(shape, dtype=torch.float32) -> TensorSpec:
    return TensorSpec(tuple(shape), dtype)


def _i(shape) -> TensorSpec:
    return TensorSpec(tuple(shape), torch.int32)


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, TensorSpec]:
    """Stand-ins for the model-input batch dict."""
    b, s = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)
    specs: Dict[str, TensorSpec] = {}
    if shape.kind == "decode":
        if cfg.frontend == "embed_stub":
            specs["embeds"] = _f((b, 1, cfg.d_model), dt)
        else:
            specs["tokens"] = _i((b, 1))
        specs["positions"] = _i((b, 1))
    else:
        if cfg.frontend == "embed_stub":
            specs["embeds"] = _f((b, s, cfg.d_model), dt)
        else:
            specs["tokens"] = _i((b, s))
        if shape.kind == "train":
            specs["targets"] = _i((b, s))
    if "cross_attn" in cfg.block_pattern:
        specs["image_embeds"] = _f((b, max(cfg.n_patches, 1), cfg.d_model),
                                   dt)
    return specs


def cache_specs(cfg: ModelConfig, shape: ShapeSpec) -> list:
    """Stand-ins matching ``LM.init_cache(B, S)``: one entry a layer."""
    b, s = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)
    kinds = tuple(cfg.block_pattern) * cfg.repeats
    out = []
    for kind in kinds:
        if kind in ATTN_KINDS:
            out.append({"k": _f((b, s, cfg.n_kv_heads, cfg.d_head), dt),
                        "v": _f((b, s, cfg.n_kv_heads, cfg.d_head), dt),
                        "len": _i((b,))})
        elif kind == "mamba2":
            d_inner = cfg.ssm_expand * cfg.d_model
            nh = d_inner // cfg.ssm_head_dim
            out.append({"state": _f((b, nh, cfg.ssm_state,
                                     cfg.ssm_head_dim))})
        elif kind == "mlstm":
            dh = cfg.d_model // cfg.n_heads
            out.append({"state": _f((b, cfg.n_heads, dh, dh + 1))})
        elif kind == "slstm":
            out.append({"state": tuple(_f((b, cfg.d_model))
                                       for _ in range(3))})
        else:
            raise ValueError(kind)
    return out
