"""Decoder-only LM: the port of src/repro/models/lm.py for dense
attention-only configs.

The reference stacks each pattern position's parameters over repeats
and runs one ``lax.scan`` (with remat and sequence sharding); those are
JAX execution knobs, and the port loops over its layers in Python.
Layer ``r * len(block_pattern) + j`` of the port is slice ``r`` of the
reference's ``params["blocks"][j]`` (``repro_torch.convert``).

Entry points, as methods, with the reference's batch dicts
(``tokens`` (B, S) int32 or int64, ``targets`` and ``loss_weights`` (B,)
for the loss, ``positions`` (B, 1) for a decode step):
  forward(batch)             -> final hidden states (B, S, d)
  logits(batch)              -> (B, S, V)
  loss(batch)                -> scalar LM loss (chunked, LGD-weighted)
  pooled_features(batch)     -> (B, d) f32 per-example LGD features
  lm_head_query()            -> (d,) f32 LGD query
  prefill(batch, cache)      -> (hidden, cache)
  decode_hidden(batch, cache)-> (hidden (B, 1, d), cache)
  decode_step(batch, cache)  -> (logits (B, 1, V), cache)
With grad enabled and ``cfg.remat`` each block runs under
``torch.utils.checkpoint`` (the reference's remat'd scan body), so
training keeps one block's activations at a time.  Prefill and decode
run without autograd and update the cache in place (``models.layers``).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels import resolve_device
from .config import ModelConfig
from .layers import (
    MLP,
    Attention,
    EmbedGroup,
    chunked_cross_entropy,
    init_attention_cache,
    rope_tables,
)

# where ROADMAP.md's module queue ports what this module refuses
ROADMAP_OTHER_MIXERS = ("ROADMAP.md queue 1, item 3 (moe, ssm, "
                        "cross-attention, shared_attn, embed_stub)")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port does not run yet: only dense self-attention
    blocks over token ids."""
    if tuple(cfg.block_pattern) != ("attn",):
        raise NotImplementedError(
            f"{cfg.name}: block pattern {cfg.block_pattern} is not ported; "
            f"only ('attn',) is.  See {ROADMAP_OTHER_MIXERS}")
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE FFNs are not ported.  See "
            f"{ROADMAP_OTHER_MIXERS}")
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: frontend {cfg.frontend!r} is not ported.  See "
            f"{ROADMAP_OTHER_MIXERS}")


class Block(nn.Module):
    """``attn``: self-attention, then the dense FFN (when d_ff > 0)."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        self.attn = Attention(cfg, device, dtype)
        self.ffn = MLP(cfg, device, dtype) if cfg.d_ff > 0 else None

    def forward(self, x, rope_cs, cache=None):
        x, cache = self.attn(x, rope_cs, cache)
        if self.ffn is not None:
            x = self.ffn(x)
        return x, cache


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device):
        """Uninitialised weights of type ``cfg.dtype`` on ``device``; see
        ``LM.init``."""
        super().__init__()
        check_supported(cfg)
        dtype = getattr(torch, cfg.dtype)
        self.cfg = cfg
        self.dtype = dtype
        self.embed_group = EmbedGroup(cfg, device, dtype)
        self.blocks = nn.ModuleList(
            Block(cfg, device, dtype) for _ in range(cfg.n_layers))

    @classmethod
    def init(cls, cfg: ModelConfig, *, seed: int = 0,
             device="cuda") -> "LM":
        """Random weights from a generator seeded with ``seed`` on
        ``device`` (the card unless the caller asks for the CPU), drawn
        as the reference draws them: normals scaled by fan-in, norm
        scales one.  The same seed gives the same weights on one device
        type, not across devices or against JAX."""
        device = resolve_device(device)
        lm = cls(cfg, device=device)
        gen = torch.Generator(device=device).manual_seed(seed)
        lm.embed_group.reset_parameters(gen)
        for blk in lm.blocks:
            blk.attn.reset_parameters(gen)
            if blk.ffn is not None:
                blk.ffn.reset_parameters(gen)
        return lm

    @property
    def device(self) -> torch.device:
        return self.embed_group.embed.device

    def _run(self, x, positions, cache):
        rope_cs = rope_tables(positions, self.cfg.d_head, self.cfg.rope_theta)
        new_cache = None if cache is None else []
        remat = cache is None and self.cfg.remat and torch.is_grad_enabled()
        for i, blk in enumerate(self.blocks):
            if remat:
                x, c = checkpoint(blk, x, rope_cs, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, c = blk(x, rope_cs, None if cache is None else cache[i])
            if cache is not None:
                new_cache.append(c)
        return x, new_cache

    def _prompt(self, batch):
        x = self.embed_group.embed_tokens(batch["tokens"])
        b, s = x.shape[:2]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
        return x, positions

    def forward(self, batch) -> torch.Tensor:
        x, positions = self._prompt(batch)
        return self._run(x, positions, None)[0]

    def logits(self, batch) -> torch.Tensor:
        return self.embed_group.lm_logits(self.forward(batch))

    def loss(self, batch) -> torch.Tensor:
        """Mean next-token xent of ``batch["targets"]``, each example
        weighted by ``batch["loss_weights"]`` when given."""
        return chunked_cross_entropy(
            self.embed_group, self.cfg, self.forward(batch),
            batch["targets"], weights=batch.get("loss_weights"))

    # -- LGD feature hooks (paper Sec. 3.2: the BERT recipe) ---------------

    def pooled_features(self, batch) -> torch.Tensor:
        """Per-example feature vector: the mean-pooled final hidden state
        (f32) that the LSH index hashes."""
        return self.forward(batch).float().mean(dim=1)

    def lm_head_query(self) -> torch.Tensor:
        """LGD query from the output layer: the mean lm_head column (f32),
        in feature space."""
        return self.embed_group.lm_head.float().mean(dim=1)

    def init_cache(self, batch: int, max_len: int) -> list:
        """One ``{"k", "v", "len"}`` cache per layer."""
        return [init_attention_cache(self.cfg, batch, max_len, self.device,
                                     self.dtype)
                for _ in range(self.cfg.n_layers)]

    @torch.no_grad()
    def prefill(self, batch, cache: list):
        """Run the prompt, writing its K/V at offset 0; returns (h, cache)."""
        x, positions = self._prompt(batch)
        return self._run(x, positions, cache)

    @torch.no_grad()
    def decode_hidden(self, batch, cache: list):
        """One-token decode up to (not including) the lm head."""
        x = self.embed_group.embed_tokens(batch["tokens"])
        return self._run(x, batch["positions"], cache)

    @torch.no_grad()
    def decode_step(self, batch, cache: list):
        """Returns (logits (B, 1, V), cache)."""
        h, cache = self.decode_hidden(batch, cache)
        return self.embed_group.lm_logits(h), cache
