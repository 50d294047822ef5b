"""Plain PyTorch version of the gather+weight kernel."""

from __future__ import annotations

from typing import Optional

import torch


def gather_weight_ref(store: torch.Tensor, idx: torch.Tensor,
                      probs: torch.Tensor, *, p_floor: float,
                      n_rows: Optional[int] = None):
    """rows = store[idx]; w = 1/(max(p, p_floor) * N).

    store: (N, W) int32; idx: (m,) int64; probs: (m,) f32; ``n_rows``:
    the N of the weight (a streaming store's live count), the store's
    height by default.  Returns (rows (m, W) int32, w (m,) f32).  The
    weight is an f32 product and one correctly rounded division, as in
    the reference.
    """
    rows = store.index_select(0, idx)
    n = store.shape[0] if n_rows is None else n_rows
    w = torch.reciprocal(torch.clamp(probs.to(torch.float32), min=p_floor)
                         * n)
    return rows, w
