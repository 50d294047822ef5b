"""Public SimHash entry: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors."""

from __future__ import annotations

import torch

from .. import any_dtensor, on_cuda
from .kernel import simhash_codes_cuda
from .ref import simhash_codes_ref


def simhash_codes(x: torch.Tensor, w: torch.Tensor, *, k: int,
                  l: int) -> torch.Tensor:
    """Packed SimHash codes (N, L) int64 of x (N, d) under w (d, L*K).

    On a card the kernel writes the codes table-major, so the result is
    the (N, L) transpose view of a contiguous (L, N) tensor — the layout
    the index sorts.  DTensor arguments: the codes of the whole rows on
    every rank, a replicated DTensor."""
    if any_dtensor(x, w):
        from repro_torch.dist.sharding import replicated_call
        return replicated_call(simhash_codes, x, w, k=k, l=l)
    if w.shape != (x.shape[1], l * k):
        raise ValueError(
            f"projections {tuple(w.shape)} != (d={x.shape[1]}, L*K={l * k})")
    if on_cuda(x):
        return simhash_codes_cuda(x.to(torch.float32).contiguous(),
                                  w.to(torch.float32).contiguous(),
                                  k=k, l=l).T
    return simhash_codes_ref(x, w, k=k, l=l)
