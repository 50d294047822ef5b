"""ctypes wrapper of the CUDA gather+weight kernel (``csrc/gather_weight.cu``).

Replaces the TPU kernel ``_gather_weight_kernel`` /
``gather_weight_pallas`` (src/repro/kernels/gather_weight/kernel.py:48 /
:56).  Bound on the H100: bytes, ~2·m·W·4 of token rows, so a launch
costs its latency.  The design — one block per sampled row, coalesced
16- or 4-byte copies, the weight from thread 0 with IEEE division, a
device-side assert on ids outside [0, N) — is set out at the top of the
CUDA source.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import check_tensor, launches
from ..build import library

_P, _I64 = ctypes.c_void_p, ctypes.c_int64


@functools.cache
def _fn():
    fn = library("gather_weight").gather_weight_launch
    fn.argtypes = [_P, _P, _P, _P, _P, _I64, _I64, _I64, ctypes.c_float, _P]
    fn.restype = ctypes.c_int
    return fn


def gather_weight_cuda(store: torch.Tensor, idx: torch.Tensor,
                       probs: torch.Tensor, *, p_floor: float):
    """rows (m, W) int32 = store[idx], w (m,) f32 = 1/(max(p, p_floor)·N).

    store: (N, W) int32, idx: (m,) int64, probs: (m,) f32, contiguous on
    one card.  Duplicate ids are allowed; an id outside [0, N) stops the
    kernel with a device-side assert."""
    check_tensor(store, "store", torch.int32, 2)
    check_tensor(idx, "idx", torch.int64, 1, store.device)
    check_tensor(probs, "probs", torch.float32, 1, store.device)
    n, width = store.shape
    m = idx.shape[0]
    if probs.shape[0] != m:
        raise ValueError(f"idx ({m},) and probs {tuple(probs.shape)} differ")
    if n == 0 or width == 0:
        raise ValueError(f"store {tuple(store.shape)} is empty")
    rows = torch.empty((m, width), dtype=torch.int32, device=store.device)
    w = torch.empty((m,), dtype=torch.float32, device=store.device)
    if m == 0:
        return rows, w
    stream = torch.cuda.current_stream(store.device).cuda_stream
    err = _fn()(store.data_ptr(), idx.data_ptr(), probs.data_ptr(),
                rows.data_ptr(), w.data_ptr(), n, width, m, p_floor, stream)
    if err != 0:
        raise RuntimeError(
            f"gather_weight kernel launch failed: CUDA error {err}")
    launches["gather_weight"] += 1
    return rows, w
