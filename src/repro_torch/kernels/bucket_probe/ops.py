"""Public bucket-probe entries: the CUDA kernels for CUDA tensors, the
plain versions for CPU tensors.

Every entry takes a (B, ...) batch or a single unbatched query and
returns (lo, hi) int32 bounds with the batch axis dropped for the
latter, as the JAX package's wrappers do.
"""

from __future__ import annotations

import torch

from .. import any_dtensor, on_cuda
from .kernel import (
    bucket_probe_codes_cuda,
    bucket_probe_cuda,
    bucket_probe_multi_cuda,
)
from .ref import bucket_probe_codes_ref, bucket_probe_multi_ref, bucket_probe_ref


def _check_tables(sorted_codes: torch.Tensor, l: int):
    if sorted_codes.shape[0] != l:
        raise ValueError(
            f"sorted_codes {tuple(sorted_codes.shape)} has "
            f"{sorted_codes.shape[0]} tables, expected L={l}")


def bucket_probe(q: torch.Tensor, w: torch.Tensor,
                 sorted_codes: torch.Tensor, *, k: int, l: int):
    """Fused hash + probe -> (lo, hi) int32, (B, L) (or (L,) for 1-D q).
    DTensor arguments (here and in the other probes): the probe of the
    whole queries on every rank, replicated DTensors out."""
    if any_dtensor(q, w, sorted_codes):
        from repro_torch.dist.sharding import replicated_call
        return replicated_call(bucket_probe, q, w, sorted_codes, k=k, l=l)
    squeeze = q.dim() == 1
    if squeeze:
        q = q[None]
    if w.shape != (q.shape[1], l * k):
        raise ValueError(
            f"projections {tuple(w.shape)} != (d={q.shape[1]}, L*K={l * k})")
    _check_tables(sorted_codes, l)
    if on_cuda(q):
        lo, hi = bucket_probe_cuda(q.to(torch.float32).contiguous(),
                                   w.to(torch.float32).contiguous(),
                                   sorted_codes, k=k, l=l)
    else:
        lo, hi = bucket_probe_ref(q, w, sorted_codes, k=k, l=l)
    return (lo[0], hi[0]) if squeeze else (lo, hi)


def bucket_probe_multi(q: torch.Tensor, w: torch.Tensor,
                       sorted_codes: torch.Tensor, masks: tuple, *,
                       k: int, l: int):
    """Fused hash + multi-probe: (lo, hi) int32, (B, J, L) (or (J, L)).

    For each query, table and Hamming-ball probe mask, the [lo, hi) slice
    of the bucket whose code is ``code(q)[t] ^ masks[j]``."""
    if any_dtensor(q, w, sorted_codes):
        from repro_torch.dist.sharding import replicated_call
        return replicated_call(bucket_probe_multi, q, w, sorted_codes,
                               masks, k=k, l=l)
    squeeze = q.dim() == 1
    if squeeze:
        q = q[None]
    if w.shape != (q.shape[1], l * k):
        raise ValueError(
            f"projections {tuple(w.shape)} != (d={q.shape[1]}, L*K={l * k})")
    _check_tables(sorted_codes, l)
    if on_cuda(q):
        lo, hi = bucket_probe_multi_cuda(q.to(torch.float32).contiguous(),
                                         w.to(torch.float32).contiguous(),
                                         sorted_codes, tuple(masks),
                                         k=k, l=l)
    else:
        lo, hi = bucket_probe_multi_ref(q, w, sorted_codes, masks, k=k, l=l)
    return (lo[0], hi[0]) if squeeze else (lo, hi)


def bucket_probe_codes(qcodes: torch.Tensor, sorted_codes: torch.Tensor):
    """Probe pre-hashed query codes (B, L) or (L,) int64 (quadratic SRP)."""
    if any_dtensor(qcodes, sorted_codes):
        from repro_torch.dist.sharding import replicated_call
        return replicated_call(bucket_probe_codes, qcodes, sorted_codes)
    squeeze = qcodes.dim() == 1
    if squeeze:
        qcodes = qcodes[None]
    _check_tables(sorted_codes, qcodes.shape[1])
    if on_cuda(qcodes):
        lo, hi = bucket_probe_codes_cuda(qcodes.contiguous(), sorted_codes)
    else:
        lo, hi = bucket_probe_codes_ref(qcodes, sorted_codes)
    return (lo[0], hi[0]) if squeeze else (lo, hi)
