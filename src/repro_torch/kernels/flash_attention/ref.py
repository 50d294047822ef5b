"""Plain PyTorch versions of flash attention and flash decode.

f32 inside, the input type out, masked logits at -1e30 — as the JAX
package's oracles (src/repro/kernels/flash_attention/ref.py)."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  scale: float | None = None) -> torch.Tensor:
    """q (B, Hkv, G, S, D), k/v (B, Hkv, S, D) -> (B, Hkv, G, S, D)."""
    s, d = q.shape[-2:]
    scale = d ** -0.5 if scale is None else scale
    logits = torch.einsum("bhgqd,bhkd->bhgqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.float())
    return out.to(q.dtype)


def decode_ref(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               kv_len: torch.Tensor, *,
               scale: float | None = None) -> torch.Tensor:
    """q (B, Hkv, G, D), cache (B, Hkv, S, D), kv_len (B,) -> (B, Hkv, G, D)."""
    d = q.shape[-1]
    s = k_cache.shape[2]
    scale = d ** -0.5 if scale is None else scale
    logits = torch.einsum("bhgd,bhkd->bhgk", q.float(),
                          k_cache.float()) * scale
    mask = (torch.arange(s, device=q.device)[None, :]
            < kv_len.to(q.device)[:, None])                      # (B, S)
    logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", probs, v_cache.float())
    return out.to(q.dtype)
