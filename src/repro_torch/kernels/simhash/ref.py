"""Plain PyTorch version of the SimHash kernel."""

from __future__ import annotations

import torch

from .. import require_full_fp32


def pack_bits(bits: torch.Tensor, k: int) -> torch.Tensor:
    """bits: (..., L, K) bool -> (..., L) int64 packed codes in [0, 2^K)."""
    weights = torch.ones((), dtype=torch.int64, device=bits.device) << \
        torch.arange(k, dtype=torch.int64, device=bits.device)
    return (bits.to(torch.int64) * weights).sum(-1)


def simhash_codes_ref(x: torch.Tensor, w: torch.Tensor, *, k: int,
                      l: int) -> torch.Tensor:
    """codes[n, t] = sum_k (x[n] @ w[:, t*K+k] >= 0) << k  — (N, L) int64."""
    require_full_fp32()
    proj = x.to(torch.float32) @ w.to(torch.float32)          # (N, L*K)
    return pack_bits((proj >= 0).reshape(x.shape[0], l, k), k)
