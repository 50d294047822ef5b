"""ctypes wrappers of the CUDA bucket-probe kernels (``csrc/bucket_probe.cu``).

Replace the three TPU kernels of src/repro/kernels/bucket_probe/kernel.py:
``bucket_probe_pallas`` (:164), ``bucket_probe_multi_pallas`` (:200) and
``bucket_probe_codes_pallas`` (:246).  The TPU kernels count every
sorted code per call; these do one interleaved lower/upper-bound binary
search per (query, probe, table) thread, so they are bound by the
latency of ~log2(N) dependent loads rather than by streaming L*N codes
(the reasoning is at the top of the CUDA source).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import check_tensor, launches
from ..build import library

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


@functools.cache
def _fn(name: str):
    fn = getattr(library("bucket_probe"), name)
    fn.argtypes = {
        "bucket_probe_launch":
            [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I64, _P],
        "bucket_probe_multi_launch":
            [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I64, _P],
        "bucket_probe_codes_launch":
            [_P, _P, _P, _P, _I, _I, _I64, _P],
    }[name]
    fn.restype = ctypes.c_int
    return fn


def _check_sorted_codes(sc: torch.Tensor, l: int, device) -> int:
    check_tensor(sc, "sorted_codes", torch.int64, 2, device)
    if sc.shape[0] != l:
        raise ValueError(f"sorted_codes {tuple(sc.shape)} has "
                         f"{sc.shape[0]} tables, expected L={l}")
    n = sc.shape[1]
    if not 1 <= n < 2 ** 31:
        raise ValueError(f"index size N={n} must be in [1, 2^31)")
    return n


def _check_query(q, w, k, l):
    check_tensor(q, "q", torch.float32, 2)
    check_tensor(w, "w", torch.float32, 2, q.device)
    if w.shape != (q.shape[1], l * k):
        raise ValueError(
            f"w {tuple(w.shape)} != (d={q.shape[1]}, L*K={l * k})")
    if not 1 <= k <= 32:
        raise ValueError(f"K must be in [1, 32], got {k}")


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def bucket_probe_cuda(q: torch.Tensor, w: torch.Tensor,
                      sorted_codes: torch.Tensor, *, k: int, l: int):
    """Fused hash + probe: q (B, d) f32 -> (lo, hi) int32, each (B, L)."""
    _check_query(q, w, k, l)
    n = _check_sorted_codes(sorted_codes, l, q.device)
    b, d = q.shape
    lo = torch.empty((b, l), dtype=torch.int32, device=q.device)
    hi = torch.empty_like(lo)
    if b == 0:
        return lo, hi
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _raise_on(_fn("bucket_probe_launch")(
        q.data_ptr(), w.data_ptr(), sorted_codes.data_ptr(), lo.data_ptr(),
        hi.data_ptr(), b, d, l, k, n, stream), "bucket_probe")
    launches["bucket_probe"] += 1
    return lo, hi


def bucket_probe_multi_cuda(q: torch.Tensor, w: torch.Tensor,
                            sorted_codes: torch.Tensor, masks: tuple, *,
                            k: int, l: int):
    """Fused hash + J-way probe: (lo, hi) int32, each (B, J, L)."""
    _check_query(q, w, k, l)
    n = _check_sorted_codes(sorted_codes, l, q.device)
    j = len(masks)
    if not 1 <= j <= 1 + 32 + 32 * 31 // 2:
        raise ValueError(f"number of probe masks J={j} out of range")
    if any(not 0 <= m < 2 ** 32 for m in masks):
        raise ValueError(f"probe masks must fit 32 bits: {masks}")
    b, d = q.shape
    lo = torch.empty((b, j, l), dtype=torch.int32, device=q.device)
    hi = torch.empty_like(lo)
    if b == 0:
        return lo, hi
    marr = (ctypes.c_uint32 * j)(*masks)   # copied into the launch params
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _raise_on(_fn("bucket_probe_multi_launch")(
        q.data_ptr(), w.data_ptr(), sorted_codes.data_ptr(),
        ctypes.addressof(marr), j, lo.data_ptr(), hi.data_ptr(), b, d, l, k,
        n, stream), "bucket_probe_multi")
    launches["bucket_probe_multi"] += 1
    return lo, hi


def bucket_probe_codes_cuda(qcodes: torch.Tensor,
                            sorted_codes: torch.Tensor):
    """Probe pre-hashed codes: qcodes (B, L) int64 -> (lo, hi) int32 (B, L)."""
    check_tensor(qcodes, "qcodes", torch.int64, 2)
    b, l = qcodes.shape
    n = _check_sorted_codes(sorted_codes, l, qcodes.device)
    lo = torch.empty((b, l), dtype=torch.int32, device=qcodes.device)
    hi = torch.empty_like(lo)
    if b == 0:
        return lo, hi
    stream = torch.cuda.current_stream(qcodes.device).cuda_stream
    _raise_on(_fn("bucket_probe_codes_launch")(
        qcodes.data_ptr(), sorted_codes.data_ptr(), lo.data_ptr(),
        hi.data_ptr(), b, l, n, stream), "bucket_probe_codes")
    launches["bucket_probe_codes"] += 1
    return lo, hi
