"""Public gather+weight entry: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors.

Unlike the reference's wrapper there is no lane padding: the kernel
takes any row width, so the store stays (N, S+1) int32."""

from __future__ import annotations

import torch

from .. import any_dtensor, on_cuda
from .kernel import gather_weight_cuda
from .ref import gather_weight_ref


def gather_weight(store: torch.Tensor, idx: torch.Tensor,
                  probs: torch.Tensor, *, p_floor: float = 1e-8):
    """Fused batch assembly: (rows (m, W) int32, weights (m,) f32).
    DTensor arguments: the whole batch on every rank, replicated."""
    if any_dtensor(store, idx, probs):
        from repro_torch.dist.sharding import replicated_call
        return replicated_call(gather_weight, store, idx, probs,
                               p_floor=p_floor)
    if idx.shape != probs.shape or idx.dim() != 1:
        raise ValueError(
            f"idx {tuple(idx.shape)} and probs {tuple(probs.shape)} must "
            "be matching 1-D tensors")
    if on_cuda(store):
        return gather_weight_cuda(store, idx.to(torch.int64).contiguous(),
                                  probs.to(torch.float32).contiguous(),
                                  p_floor=p_floor)
    return gather_weight_ref(store, idx, probs, p_floor=p_floor)
