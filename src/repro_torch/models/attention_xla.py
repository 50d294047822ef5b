"""Chunked attention in plain PyTorch: a loop over query blocks.

The port of src/repro/models/attention_xla.py, the ``attn_impl="chunked"``
default.  The reference computes it outside any Pallas kernel, so it has
no kernel here either.  Each q-block attends to the whole (masked) KV
with an f32 softmax, so the activation memory is O(block_q * S).
"""

from __future__ import annotations

import torch

from ..kernels import any_dtensor
from ..kernels.flash_attention.ref import NEG_INF


def chunked_gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, block_q: int = 1024,
                          scale: float | None = None) -> torch.Tensor:
    """q (B, S, Hq, D), k/v (B, S_kv, Hkv, D) -> (B, S, Hq, D).  Under a
    mesh each rank attends over its own batch rows and heads
    (``dist.sharding.local_map``)."""
    if any_dtensor(q, k, v):
        from ..dist.sharding import local_map
        return local_map(
            lambda *a: chunked_gqa_attention(*a, causal=causal,
                                             block_q=block_q, scale=scale),
            (q, k, v), ((0, 2),) * 3, ((0, 2),))
    b, s, hq, d = q.shape
    s_kv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    bq = min(block_q, s)
    kg = k.permute(0, 2, 1, 3).float()           # (B, Hkv, S_kv, D)
    vg = v.permute(0, 2, 1, 3).float()
    kv_pos = torch.arange(s_kv, device=q.device)
    outs = []
    for q0 in range(0, s, bq):
        qi = q[:, q0:q0 + bq]                     # (B, bq', Hq, D)
        n = qi.shape[1]
        qi = qi.reshape(b, n, hkv, g, d).permute(0, 2, 3, 1, 4).float()
        logits = torch.einsum("bhgqd,bhkd->bhgqk", qi, kg) * scale
        if causal:
            q_pos = q0 + torch.arange(n, device=q.device)
            mask = q_pos[:, None] >= kv_pos[None, :]
            logits = logits.masked_fill(~mask, NEG_INF)
        m = logits.amax(dim=-1, keepdim=True)
        p = torch.exp(logits - m)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bhgqk,bhkd->bhgqd", p / l.clamp_min(1e-30), vg)
        outs.append(o.to(q.dtype).permute(0, 3, 1, 2, 4).reshape(b, n, hq, d))
    return torch.cat(outs, dim=1)
