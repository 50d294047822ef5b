"""Public attention entries in the model's layout.

``use_kernel=True`` (the model's ``attn_impl="pallas"``) dispatches by
device: a CUDA tensor launches the hand-written kernel, or raises; a CPU
tensor takes the plain version.  ``use_kernel=False`` (``"ref"``) takes
the plain version on any device.  The kernels have no backward, as the
TPU kernel has no custom VJP, so the kernel path refuses a tensor that
needs a gradient.

The (B, S, H, D) activations and the (B, S_max, Hkv, D) cache reach the
kernels as permuted views, and the kernels write the (B, S, Hq, D)
result in place: no layout copy on the card.

Under a mesh the entries take DTensors: attention is local per batch row
and per head, so each rank runs the kernel (or, on the CPU, the plain
version) on its own rows and heads (``dist.sharding.local_map``), where
q and k/v are split alike; a split they do not share is gathered first
(a sequence-sharded decode cache is all-gathered).
"""

from __future__ import annotations

import torch

from .. import any_dtensor, on_cuda
from .kernel import flash_attention_cuda, flash_decode_cuda
from .ref import attention_ref, decode_ref


def _kernel_path(use_kernel: bool, *ts: torch.Tensor) -> bool:
    if not (use_kernel and on_cuda(ts[0])):
        return False
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError("the flash kernels have no backward: run under "
                           "torch.no_grad(), or use attn_impl='chunked'")
    return True


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  use_kernel: bool = True) -> torch.Tensor:
    """Grouped-query attention: q (B, S, Hq, D), k/v (B, S, Hkv, D) ->
    (B, S, Hq, D)."""
    if any_dtensor(q, k, v):
        from repro_torch.dist.sharding import local_map
        return local_map(
            lambda *a: gqa_attention(*a, causal=causal,
                                     use_kernel=use_kernel),
            (q, k, v), ((0, 2),) * 3, ((0, 2),))
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    g = hq // hkv
    qg = q.reshape(b, s, hkv, g, d).permute(0, 2, 3, 1, 4)   # (B,Hkv,G,S,D)
    kg = k.permute(0, 2, 1, 3)                               # (B,Hkv,S,D)
    vg = v.permute(0, 2, 1, 3)
    if _kernel_path(use_kernel, q, k, v):
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
        flash_attention_cuda(
            qg, kg, vg, causal=causal,
            out=out.view(b, s, hkv, g, d).permute(0, 2, 3, 1, 4))
        return out
    out = attention_ref(qg, kg, vg, causal=causal)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, d)


def gqa_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               kv_len: torch.Tensor, *,
               use_kernel: bool = True) -> torch.Tensor:
    """Single-token decode: q (B, 1, Hq, D) against the cache
    (B, S, Hkv, D), valid up to kv_len (B,) -> (B, 1, Hq, D)."""
    if any_dtensor(q, k_cache, v_cache, kv_len):
        from repro_torch.dist.sharding import local_map
        return local_map(
            lambda *a: gqa_decode(*a, use_kernel=use_kernel),
            (q, k_cache, v_cache, kv_len),
            ((0, 2), (0, 2), (0, 2), (0, None)), ((0, 2),))
    b, _, hq, d = q.shape
    hkv = k_cache.shape[2]
    g = hq // hkv
    qg = q[:, 0].reshape(b, hkv, g, d)
    kg = k_cache.permute(0, 2, 1, 3)
    vg = v_cache.permute(0, 2, 1, 3)
    if _kernel_path(use_kernel, q, k_cache, v_cache):
        out = torch.empty((b, 1, hq, d), dtype=q.dtype, device=q.device)
        flash_decode_cuda(qg, kg, vg, kv_len.to(torch.int32),
                          out=out.view(b, hkv, g, d))
        return out
    return decode_ref(qg, kg, vg, kv_len).reshape(b, 1, hq, d)
