"""ctypes wrappers of the CUDA bucket-probe kernels (``csrc/bucket_probe.cu``).

Replace the three TPU kernels of src/repro/kernels/bucket_probe/kernel.py:
``bucket_probe_pallas`` (:164), ``bucket_probe_multi_pallas`` (:200) and
``bucket_probe_codes_pallas`` (:246).  The TPU kernels count every
sorted code per call; these search.  What bounds them is rounds of L2
latency and the launch, not bytes, so the design cuts rounds: a block
hashes its query once per table as a GEMV over w spread over its
threads (above 128 features, over blocks too, the last block to finish
adding the parts' sums in a fixed order), and a warp finds each (probe,
table)'s lo and hi by a 32-way k-ary search, 4 rounds at N 463,715
where a binary search takes 19.  The reasoning is at the top of the
CUDA source; ``probe_plan`` mirrors its launch rules.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import arrival_counts, check_tensor, launches, sm_count
from ..build import library

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGTYPES = {
    "bucket_probe_launch":
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I64, _I, _I, _P],
    "bucket_probe_multi_launch":
        [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I64, _I, _I,
         _P],
    "bucket_probe_codes_launch":
        [_P, _P, _P, _P, _I, _I, _I64, _P],
}
# the CUDA source's launch constants
THREADS = 256        # kThreads: 8 warps a block
FEAT_ONE = 128       # kFeatOne: up to this many features, one block sums all
FEAT_PART = 64       # kFeatPart: above it, features per part
MAX_MASKS = 1 + 32 + 32 * 31 // 2   # kMaxMasks, all passed by value
BLOCKS_PER_SM = 2    # the hashed launch's aim when the batch allows it


@functools.cache
def _fn(name: str, defines: tuple = ()):
    fn = getattr(library("bucket_probe", defines), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def probe_plan(b: int, d: int, l: int, k: int, sms: int) -> tuple[int, int]:
    """(tables a block hashes, feature parts) of a hashed probe launch.

    Up to FEAT_ONE features one block sums every feature in order
    (bitwise the simhash kernel's sums); above, blocks sum parts of
    FEAT_PART features and the last of them adds the parts' sums.  A
    block hashes whole tables, at most THREADS columns, and searches
    their probes.  Fewer tables a block means fewer loads before its
    searches start but more blocks: the fewest of 1, 2, 4, 8 tables that
    keeps the launch within BLOCKS_PER_SM blocks per SM, else the most
    (on the H100, 1 at B 1, d 91; 2 at d 3,072; 8 at B 16)."""
    parts = 1 if d <= FEAT_ONE else -(-d // FEAT_PART)
    most = max(1, min(8, l, THREADS // k))
    tables = 1
    while tables < most and b * -(-l // tables) * parts > BLOCKS_PER_SM * sms:
        tables *= 2
    return min(tables, most), parts


@functools.lru_cache(maxsize=64)
def _host_masks(masks: tuple):
    return (ctypes.c_uint32 * len(masks))(*masks)


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


def _probe_hashed(name: str, q, w, sc, masks: tuple, k: int, l: int):
    """Launch the hashed probe for ``masks``: (lo, hi) int32 (B, J, L)."""
    _check_query(q, w, k, l)
    n = _check_sorted_codes(sc, l, q.device)
    b, d = q.shape
    j = len(masks)
    lo = torch.empty((b, j, l), dtype=torch.int32, device=q.device)
    hi = torch.empty_like(lo)
    if b == 0:
        return lo, hi
    tables, parts = probe_plan(b, d, l, k, sm_count(q.device.index))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part = arrived = None
    if parts > 1:
        groups = -(-l // tables)
        part = torch.empty(b * groups * parts * tables * k,
                           dtype=torch.float32, device=q.device)
        arrived = arrival_counts(q.device, stream, b * groups)
    tail = (lo.data_ptr(), hi.data_ptr(),
            None if part is None else part.data_ptr(),
            None if arrived is None else arrived.data_ptr(),
            b, d, l, k, n, tables, parts, stream)
    head = (q.data_ptr(), w.data_ptr(), sc.data_ptr())
    if name == "bucket_probe":
        err = _fn("bucket_probe_launch")(*head, *tail)
    else:
        err = _fn("bucket_probe_multi_launch")(
            *head, ctypes.addressof(_host_masks(masks)), j, *tail)
    _raise_on(err, name)
    launches[name] += 1
    return lo, hi


def bucket_probe_cuda(q: torch.Tensor, w: torch.Tensor,
                      sorted_codes: torch.Tensor, *, k: int, l: int):
    """Fused hash + probe: q (B, d) f32 -> (lo, hi) int32, each (B, L)."""
    lo, hi = _probe_hashed("bucket_probe", q, w, sorted_codes, (0,), k, l)
    return lo[:, 0], hi[:, 0]


def bucket_probe_multi_cuda(q: torch.Tensor, w: torch.Tensor,
                            sorted_codes: torch.Tensor, masks: tuple, *,
                            k: int, l: int):
    """Fused hash + J-way probe: (lo, hi) int32, each (B, J, L)."""
    masks = tuple(masks)
    if not 1 <= len(masks) <= MAX_MASKS:
        raise ValueError(f"number of probe masks J={len(masks)} out of range")
    if any(not 0 <= m < 2 ** 32 for m in masks):
        raise ValueError(f"probe masks must fit 32 bits: {masks}")
    return _probe_hashed("bucket_probe_multi", q, w, sorted_codes, masks,
                         k, l)


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
