"""Chunked attention in plain PyTorch: a loop over query blocks.

The port of src/repro/models/attention_xla.py, the ``attn_impl="chunked"``
default.  The reference computes it outside any Pallas kernel, so it has
no kernel here either.  Each q-block attends to the whole (masked) KV
with an f32 softmax (``q_block``), so a block's scores are O(block_q * S).

In training with more than one q-block each block runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` on its
scan body): the backward keeps the block's inputs and recomputes its
(block_q x S) scores and softmax, one block at a time, instead of
storing every block's.  Without grad, or with a single q-block (whose
scores are the bound already), the blocks run as they are.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels import any_dtensor
from ..kernels.flash_attention.ref import NEG_INF


def q_block(qi: torch.Tensor, kg: torch.Tensor, vg: torch.Tensor, q0: int,
            *, causal: bool, scale: float) -> torch.Tensor:
    """One q-block: qi (B, n, Hq, D), the rows from ``q0``, attends to kg /
    vg (B, Hkv, S_kv, D) f32 -> (B, n, Hq, D) in qi's dtype."""
    b, n, hq, d = qi.shape
    hkv = kg.shape[1]
    x = qi.reshape(b, n, hkv, hq // hkv, d).permute(0, 2, 3, 1, 4).float()
    logits = torch.einsum("bhgqd,bhkd->bhgqk", x, kg) * scale
    if causal:
        q_pos = q0 + torch.arange(n, device=qi.device)
        kv_pos = torch.arange(kg.shape[2], device=qi.device)
        logits = logits.masked_fill(~(q_pos[:, None] >= kv_pos[None, :]),
                                    NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p / l.clamp_min(1e-30), vg)
    return o.to(qi.dtype).permute(0, 3, 1, 2, 4).reshape(b, n, hq, d)


def chunked_gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, block_q: int = 1024,
                          scale: float | None = None) -> torch.Tensor:
    """q (B, S, Hq, D), k/v (B, S_kv, Hkv, D) -> (B, S, Hq, D).  Under a
    mesh each rank attends over its own batch rows and heads
    (``dist.sharding.local_map``), its blocks checkpointed locally."""
    if any_dtensor(q, k, v):
        from ..dist.sharding import local_map
        return local_map(
            lambda *a: chunked_gqa_attention(*a, causal=causal,
                                             block_q=block_q, scale=scale),
            (q, k, v), ((0, 2),) * 3, ((0, 2),))
    s, d = q.shape[1], q.shape[3]
    scale = d ** -0.5 if scale is None else scale
    bq = min(block_q, s)
    kg = k.permute(0, 2, 1, 3).float()           # (B, Hkv, S_kv, D)
    vg = v.permute(0, 2, 1, 3).float()
    remat = torch.is_grad_enabled() and s > bq
    outs = []
    for q0 in range(0, s, bq):
        qi = q[:, q0:q0 + bq]
        if remat:
            outs.append(checkpoint(q_block, qi, kg, vg, q0, causal=causal,
                                   scale=scale, use_reentrant=False,
                                   preserve_rng_state=False))
        else:
            outs.append(q_block(qi, kg, vg, q0, causal=causal, scale=scale))
    return torch.cat(outs, dim=1)
