"""Plain PyTorch versions of the bucket-probe kernels."""

from __future__ import annotations

import torch

from ..simhash.ref import simhash_codes_ref


def bucket_probe_codes_ref(qcodes: torch.Tensor, sorted_codes: torch.Tensor):
    """Two batched binary searches per table.

    qcodes: (B, L) int64; sorted_codes: (L, N) int64 ascending per row.
    Returns (lo, hi) int32 (B, L): per table, the [lo, hi) slice of the
    query's bucket.
    """
    qt = qcodes.T.contiguous()                                 # (L, B)
    lo = torch.searchsorted(sorted_codes, qt, side="left", out_int32=True)
    hi = torch.searchsorted(sorted_codes, qt, side="right", out_int32=True)
    return lo.T, hi.T


def bucket_probe_ref(q: torch.Tensor, w: torch.Tensor,
                     sorted_codes: torch.Tensor, *, k: int, l: int):
    """Hash B queries then probe: the plain version of the fused kernel."""
    return bucket_probe_codes_ref(simhash_codes_ref(q, w, k=k, l=l),
                                  sorted_codes)


def bucket_probe_multi_ref(q: torch.Tensor, w: torch.Tensor,
                           sorted_codes: torch.Tensor, masks,
                           *, k: int, l: int):
    """Hash B queries, XOR every code with each probe mask, and search.

    Returns (lo, hi) int32 of shape (B, J, L), J = len(masks); [b, j, t]
    is the bucket slice of ``code(q_b)[t] ^ masks[j]`` in table t.
    """
    qcodes = simhash_codes_ref(q, w, k=k, l=l)                 # (B, L)
    marr = torch.tensor(list(masks), dtype=torch.int64, device=q.device)
    pcodes = qcodes[:, None, :] ^ marr[None, :, None]          # (B, J, L)
    b, j, ll = pcodes.shape
    lo, hi = bucket_probe_codes_ref(pcodes.reshape(b * j, ll), sorted_codes)
    return lo.reshape(b, j, ll), hi.reshape(b, j, ll)
