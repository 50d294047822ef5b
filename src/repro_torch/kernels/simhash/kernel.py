"""ctypes wrapper of the CUDA SimHash kernel (``csrc/simhash.cu``).

Replaces the TPU kernel ``_simhash_kernel`` / ``simhash_codes_pallas``
(src/repro/kernels/simhash/kernel.py:53 / :76).  Bound on the H100: fp32
FMAs on CUDA cores (2·N·d·L·K operations; no TF32, for code parity).
The design — register-resident projection sums, shared-memory staging
with broadcast weight reads, table-major coalesced code writes — is set
out at the top of the CUDA source.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import check_tensor, launches
from ..build import library

MAX_K = 32


@functools.cache
def _fn():
    fn = library("simhash").simhash_codes_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def simhash_codes_cuda(x: torch.Tensor, w: torch.Tensor, *, k: int,
                       l: int) -> torch.Tensor:
    """Packed codes, table-major: (L, N) int64 in [0, 2^K).

    x: (N, d) float32, w: (d, L*K) float32, both contiguous on one card.
    """
    check_tensor(x, "x", torch.float32, 2)
    check_tensor(w, "w", torch.float32, 2, x.device)
    n, d = x.shape
    if w.shape != (d, l * k):
        raise ValueError(f"w {tuple(w.shape)} != (d={d}, L*K={l * k})")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"K must be in [1, {MAX_K}], got {k}")
    codes = torch.empty((l, n), dtype=torch.int64, device=x.device)
    if n == 0:
        return codes
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _fn()(x.data_ptr(), w.data_ptr(), codes.data_ptr(), n, d, l, k,
                stream)
    if err != 0:
        raise RuntimeError(f"simhash kernel launch failed: CUDA error {err}")
    launches["simhash"] += 1
    return codes
