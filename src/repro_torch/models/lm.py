"""Decoder-only LM assembled from a block pattern: the port of
src/repro/models/lm.py.

The config's ``block_pattern``, cycled ``repeats`` times to n_layers,
names each layer's kind:
  attn         self-attention, then the FFN (dense MLP or MoE);
  shared_attn  the same, with ONE set of weights shared by every
               occurrence (Zamba-style), each occurrence with its own KV
               cache;
  cross_attn   self-attention, cross-attention over ``image_embeds``,
               then the FFN;
  mamba2, mlstm, slstm   the sub-quadratic mixers of ``models.ssm``, with
               no FFN.
The ``embed_stub`` frontend takes precomputed embeddings
(``batch["embeds"]``, cast to the model dtype) in place of token ids.

The reference stacks each pattern position's parameters over repeats
and runs one ``lax.scan`` with remat; the port loops over its layers in
Python.  Its sequence sharding is the port's too: with ``seq_shard``
the residual entering each repeat of the pattern is placed
``logical(x, "batch", "seq", None)`` outside decode (a no-op meshless).
Layer ``r * len(block_pattern) + j`` of the port is slice ``r`` of the
reference's ``params["blocks"][j]``; the shared block is ``shared``,
the reference's ``params["shared"]``, registered once, so it appears
once in ``named_parameters()`` (``repro_torch.convert``).

Entry points, as methods, with the reference's batch dicts
(``tokens`` (B, S) int32 or int64, or ``embeds`` (B, S, d) for an
``embed_stub`` arch; ``image_embeds`` (B, P, d) for the cross-attention
layers; ``targets`` and ``loss_weights`` (B,) for the loss;
``positions`` (B, 1) for a decode step):
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
run without autograd.  The cache is a list with one entry a layer:
attention caches (``{"k", "v", "len"}``) are updated in place
(``models.layers``); a mixer's state (``{"state": ...}``) is carried,
and its list entry replaced by the new one.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..dist.sharding import distribute_cache, logical, replicate_like
from ..kernels import resolve_device
from . import ssm
from .config import ModelConfig
from .layers import (
    MLP,
    Attention,
    EmbedGroup,
    chunked_cross_entropy,
    init_attention_cache,
    rope_tables,
)
from .moe import MoE

ATTN_KINDS = ("attn", "cross_attn", "shared_attn")
MIXERS = {"mamba2": ("mamba", ssm.Mamba2), "mlstm": ("mlstm", ssm.MLSTM),
          "slstm": ("slstm", ssm.SLSTM)}
BLOCK_KINDS = ATTN_KINDS + tuple(MIXERS)


class Block(nn.Module):
    """One layer of kind ``kind``, its parameters under the reference's
    names (``attn``, ``xattn``, ``mamba``, ``mlstm``, ``slstm``,
    ``ffn``)."""

    def __init__(self, cfg: ModelConfig, kind: str, device, dtype):
        super().__init__()
        if kind not in BLOCK_KINDS:
            raise ValueError(f"unknown block kind {kind!r}; one of "
                             f"{BLOCK_KINDS}")
        self.kind = kind
        self.ffn = None
        if kind in ATTN_KINDS:
            self.attn = Attention(cfg, device, dtype)
            if kind == "cross_attn":
                self.xattn = Attention(cfg, device, dtype)
            # attention-style blocks carry the FFN; the mixers do not
            # (Zamba puts its FFN in the shared block only)
            if cfg.is_moe:
                self.ffn = MoE(cfg, device, dtype)
            elif cfg.d_ff > 0:
                self.ffn = MLP(cfg, device, dtype)
        else:
            attr, cls = MIXERS[kind]
            setattr(self, attr, cls(cfg, device, dtype))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.children():
            m.reset_parameters(generator)

    def forward(self, x, rope_cs, image_mem=None, cache=None,
                decode: bool = False):
        """Returns (x, the layer's new cache entry or None)."""
        kind = self.kind
        if kind in ATTN_KINDS:
            x, cache = self.attn(x, rope_cs, cache)
            if kind == "cross_attn":
                # no image memory: the reference's quirk, full
                # self-attention with RoPE on cfg.attn_impl
                x, _ = self.xattn(x, rope_cs, kv=image_mem, causal=False)
            if self.ffn is not None:
                x = self.ffn(x)
            return x, cache
        mixer = getattr(self, MIXERS[kind][0])
        state = None if cache is None else cache["state"]
        if decode and kind != "slstm":     # sLSTM decodes at S = 1
            x, state = mixer.decode(x, state)
        else:
            x, state = mixer(x, state)
        return x, None if cache is None else {"state": state}


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device):
        """Uninitialised weights of type ``cfg.dtype`` on ``device``; see
        ``LM.init``."""
        super().__init__()
        dtype = getattr(torch, cfg.dtype)
        self.cfg = cfg
        self.dtype = dtype
        self.kinds = tuple(cfg.block_pattern) * cfg.repeats
        self.embed_group = EmbedGroup(cfg, device, dtype)
        # a shared_attn position holds None: its weights are ``shared``
        self.blocks = nn.ModuleList(
            None if kind == "shared_attn" else Block(cfg, kind, device, dtype)
            for kind in self.kinds)
        self.shared = (Block(cfg, "shared_attn", device, dtype)
                       if "shared_attn" in self.kinds else None)

    @classmethod
    def init(cls, cfg: ModelConfig, *, seed: int = 0,
             device="cuda") -> "LM":
        """Random weights from a generator seeded with ``seed`` on
        ``device`` (the card unless the caller asks for the CPU), drawn
        as the reference draws them: normals scaled by fan-in, norm
        scales one, the mixers' f32 constants as the reference sets them.
        The same seed gives the same weights on one device type, not
        across devices or against JAX."""
        device = resolve_device(device)
        lm = cls(cfg, device=device)
        gen = torch.Generator(device=device).manual_seed(seed)
        lm.embed_group.reset_parameters(gen)
        for blk in (*lm.blocks, lm.shared):
            if blk is not None:
                blk.reset_parameters(gen)
        return lm

    @property
    def device(self) -> torch.device:
        return self.embed_group.embed.device

    def _layer(self, i: int) -> Block:
        return self.shared if self.kinds[i] == "shared_attn" else \
            self.blocks[i]

    def _run(self, x, positions, image_mem, cache, decode: bool):
        cfg = self.cfg
        rope_cs = (rope_tables(positions, cfg.d_head, cfg.rope_theta)
                   if any(k in ATTN_KINDS for k in self.kinds) else None)
        remat = cache is None and cfg.remat and torch.is_grad_enabled()
        period = len(cfg.block_pattern)
        for i in range(len(self.kinds)):
            blk = self._layer(i)
            if cfg.seq_shard and not decode and i % period == 0:
                x = logical(x, "batch", "seq", None)
            if remat:
                x, _ = checkpoint(blk, x, rope_cs, image_mem,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, c = blk(x, rope_cs, image_mem,
                           None if cache is None else cache[i], decode)
                if cache is not None:
                    cache[i] = c
        return x, cache

    def _image_mem(self, batch, dtype):
        mem = batch.get("image_embeds")
        return None if mem is None else replicate_like(
            mem.to(dtype), self.embed_group.embed)

    def _embed(self, batch):
        if self.cfg.frontend == "embed_stub":
            return replicate_like(batch["embeds"].to(self.dtype),
                                  self.embed_group.embed)
        return self.embed_group.embed_tokens(batch["tokens"])

    def _prompt(self, batch):
        """(x, image memory, positions) of a full sequence."""
        x = self._embed(batch)
        # (S,): every row's positions, so the RoPE tables broadcast over
        # the batch (a (B, S) table would be the whole batch's on every
        # rank of a mesh)
        positions = replicate_like(torch.arange(
            x.shape[1], dtype=torch.int32, device=x.device), x)
        return x, self._image_mem(batch, x.dtype), positions

    def forward(self, batch) -> torch.Tensor:
        x, mem, positions = self._prompt(batch)
        return self._run(x, positions, mem, None, False)[0]

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
        """One cache a layer, by kind: ``{"k", "v", "len"}`` for the
        attention kinds (each shared_attn occurrence its own), else
        ``{"state": ...}`` with the mixer's zero state.  A model placed on
        a mesh gets DTensor caches, split over their batch dim where the
        data axes divide it (``dist.sharding.distribute_cache``)."""
        cfg, dev = self.cfg, self.device
        states = {"mamba2": ssm.init_mamba2_state,
                  "mlstm": ssm.init_mlstm_state,
                  "slstm": ssm.init_slstm_state}
        cache = [init_attention_cache(cfg, batch, max_len, dev, self.dtype)
                 if kind in ATTN_KINDS else
                 {"state": states[kind](cfg, batch, dev)}
                 for kind in self.kinds]
        return distribute_cache(cache, self.embed_group.embed)

    @torch.no_grad()
    def prefill(self, batch, cache: list):
        """Run the prompt, writing its K/V at offset 0 and the mixers'
        states; returns (h, cache)."""
        x, mem, positions = self._prompt(batch)
        return self._run(x, positions, mem, cache, False)

    @torch.no_grad()
    def decode_hidden(self, batch, cache: list):
        """One-token decode up to (not including) the lm head: the next
        token id (or ``embeds`` (B, 1, d)), ``positions`` (B, 1), and
        ``image_embeds`` for a cross-attention arch."""
        x = self._embed(batch)
        return self._run(x, replicate_like(batch["positions"], x),
                         self._image_mem(batch, x.dtype), cache, True)

    @torch.no_grad()
    def decode_step(self, batch, cache: list):
        """Returns (logits (B, 1, V), cache)."""
        h, cache = self.decode_hidden(batch, cache)
        return self.embed_group.lm_logits(h), cache
