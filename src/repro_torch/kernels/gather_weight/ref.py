"""Plain PyTorch version of the gather+weight kernel."""

from __future__ import annotations

import torch


def gather_weight_ref(store: torch.Tensor, idx: torch.Tensor,
                      probs: torch.Tensor, *, p_floor: float):
    """rows = store[idx]; w = 1/(max(p, p_floor) * N).

    store: (N, W) int32; idx: (m,) int64; probs: (m,) f32.
    Returns (rows (m, W) int32, w (m,) f32).  The weight is an f32
    product and one correctly rounded division, as in the reference.
    """
    rows = store.index_select(0, idx)
    w = torch.reciprocal(torch.clamp(probs.to(torch.float32), min=p_floor)
                         * store.shape[0])
    return rows, w
