"""ctypes wrappers of the CUDA batch-assembly kernels (``csrc/gather_weight.cu``).

Both replace the TPU kernel ``_gather_weight_kernel`` /
``gather_weight_pallas`` (src/repro/kernels/gather_weight/kernel.py:48 /
:56):

  * ``gather_weight_cuda`` — the gather and the weights alone.  Bound on
    the H100: bytes, ~2·m·W·4 of token rows, so a launch costs its
    latency.  One block per sampled row, coalesced 16- or 4-byte
    copies, the weight from thread 0 with IEEE division, a device-side
    assert on ids outside [0, N).
  * ``draw_assemble_cuda`` — Algorithm 1 after the probe (the candidate
    walk, the slot, the id, the collision probability and p), and with
    a token store the gather and the weight, in one launch: what the
    JAX package runs as one jitted program around its TPU kernel.  One
    block per (query, repetition); warp 0 walks 32 candidates a round
    with a ballot; the dot products sum in one fixed order.  Its band
    mode draws a banded family's norm band on the device first.

The design of each is set out at the top of the CUDA source.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import check_tensor, launches
from ..build import library

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_F = ctypes.c_float
_ARGTYPES = {
    "gather_weight_launch": [_P, _P, _P, _P, _P, _I64, _I64, _I64, _F, _P],
    "draw_assemble_launch": [_P] * 21 + [_I64] * 13 + [_F, _F, _P],
}
# the CUDA source's draw_assemble constants
DRAW_THREADS = 128                   # kDrawThreads: 4 warps a block
MAX_MASKS = 1 + 32 + 32 * 31 // 2    # kMaxMasks: the probe's mask cap
# the collision laws draw_assemble knows, in the order of its enum Law:
# "angle" is cp = 1 - acos(cos(x, q)) / pi (SRP, its sparse twin and
# Simple-LSH MIPS on augmented vectors), "quadratic" the same law on
# cos(T(x), T(q)) = (x.q)^2 / (|x|^2 |q|^2)
LAWS = ("angle", "quadratic")


@functools.cache
def _fn(name: str):
    fn = getattr(library("gather_weight"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


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
    _raise_on(_fn("gather_weight_launch")(
        store.data_ptr(), idx.data_ptr(), probs.data_ptr(), rows.data_ptr(),
        w.data_ptr(), n, width, m, p_floor, stream), "gather_weight")
    launches["gather_weight"] += 1
    return rows, w


def law_code(family) -> int:
    """draw_assemble's code of ``family``'s collision law (its
    ``cp_law``); a family whose law the kernel does not know raises."""
    law = getattr(family, "cp_law", None)
    if law not in LAWS:
        raise ValueError(
            f"the draw_assemble kernel knows no collision law {law!r} "
            f"(LSH family {getattr(family, 'name', family)!r}); it knows "
            f"{LAWS}")
    return LAWS.index(law)


@functools.lru_cache(maxsize=64)
def _host_popcounts(popcounts: tuple):
    return (ctypes.c_uint8 * len(popcounts))(*popcounts)


def draw_assemble_cuda(lo: torch.Tensor, hi: torch.Tensor,
                       order: torch.Tensor, x: torch.Tensor,
                       queries: torch.Tensor, tables: torch.Tensor,
                       slot_u: torch.Tensor,
                       fallback_ids: Optional[torch.Tensor],
                       popcounts: tuple, *, k: int, law: int,
                       p_fallback: float, store=None, p_floor: float = 1e-8,
                       n_live: Optional[int] = None,
                       d_law: Optional[int] = None,
                       starts: Optional[torch.Tensor] = None,
                       band_u: Optional[torch.Tensor] = None,
                       fallback_u: Optional[torch.Tensor] = None):
    """Algorithm 1 after the probe, in one launch.

    lo, hi: (B, J, L) int32 bucket bounds; order: (L, N) int64; x: (N, d)
    f32; queries: (B, d) f32; tables: (B, m, P) int64 table draws;
    slot_u: (B, m) f32; fallback_ids: (B, m) int64 (None in band mode,
    which draws its fallback from ``fallback_u``); ``popcounts``: the J
    probe masks' popcounts; ``law``: an index of LAWS; ``p_fallback``:
    the probability of a uniform fallback (1/N, or 1/n_live).  With
    ``store`` (N, W) int32 it also gathers the rows and computes
    1/(max(p, p_floor)·N).  ``n_live`` (a host int, a streaming index's
    live count): the fallback draws are slots of ``order[0, :n_live]``,
    mapped to ids through it, and the weights' N is n_live.  ``d_law``:
    the leading coordinates of x and the queries the law reads (all d by
    default).

    Band mode (a banded family): ``starts`` (nb+1,) int32 the bands'
    partition of the sorted order (``tables.band_starts``, left on the
    device), lo/hi (B, nb, J, L), ``band_u`` and ``fallback_u`` (B, m)
    f32.  Each block draws its band as floor(band_u · total) against
    ``starts``, walks that band's bounds, multiplies p by n_band/total,
    and on a miss takes ``order[0, floor(fallback_u · total)]`` with
    p = 1/total (``p_fallback`` is not read).

    Returns (indices (B, m) int64, probs f32, n_probes int32,
    bucket_sizes int32, fallback bool, probe_code int32, rows (B·m, W)
    int32 or None, w (B·m,) f32 or None).  A table draw outside [0, L)
    or a fallback draw outside [0, N) (or [0, n_live)) stops the kernel
    with a device-side assert."""
    banded = starts is not None
    check_tensor(lo, "lo", torch.int32, 4 if banded else 3)
    dev = lo.device
    check_tensor(hi, "hi", torch.int32, lo.dim(), dev)
    check_tensor(order, "order", torch.int64, 2, dev)
    check_tensor(x, "x", torch.float32, 2, dev)
    check_tensor(queries, "queries", torch.float32, 2, dev)
    check_tensor(tables, "tables", torch.int64, 3, dev)
    check_tensor(slot_u, "slot_u", torch.float32, 2, dev)
    nb = 1
    if banded:
        if fallback_ids is not None:
            raise ValueError("band mode draws its fallback from fallback_u: "
                             "fallback_ids must be None")
        check_tensor(starts, "starts", torch.int32, 1, dev)
        b, nb, j, n_tables = lo.shape
        if starts.shape[0] != nb + 1:
            raise ValueError(f"starts {tuple(starts.shape)} do not match "
                             f"{nb} bands")
    else:
        if band_u is not None or fallback_u is not None:
            raise ValueError("band_u and fallback_u need starts")
        check_tensor(fallback_ids, "fallback_ids", torch.int64, 2, dev)
        b, j, n_tables = lo.shape
    n, d = x.shape
    _, m, p = tables.shape
    d_law = d if d_law is None else d_law
    if not 1 <= d_law <= d:
        raise ValueError(f"d_law={d_law} outside [1, d={d}]")
    if banded:
        for t, name in ((band_u, "band_u"), (fallback_u, "fallback_u")):
            if t is None:
                raise ValueError(f"band mode needs {name}")
            check_tensor(t, name, torch.float32, 2, dev)
            if t.shape != (b, m):
                raise ValueError(f"{name} {tuple(t.shape)} is not ({b}, {m})")
    if hi.shape != lo.shape or order.shape != (n_tables, n):
        raise ValueError(f"bounds {tuple(lo.shape)} / {tuple(hi.shape)} do "
                         f"not match order {tuple(order.shape)}")
    if queries.shape != (b, d) or tables.shape[0] != b or \
            slot_u.shape != (b, m) or \
            (fallback_ids is not None and fallback_ids.shape != (b, m)):
        raise ValueError(
            f"queries {tuple(queries.shape)}, draws {tuple(tables.shape)} / "
            f"{tuple(slot_u.shape)} do not match B={b}, d={d}, or the "
            f"fallback ids' shape does")
    if len(popcounts) != j or not 1 <= j <= MAX_MASKS:
        raise ValueError(f"{len(popcounts)} mask popcounts for J={j} "
                         f"(at most {MAX_MASKS})")
    if not 1 <= k <= 32 or not 0 <= law < len(LAWS):
        raise ValueError(f"K={k} or law={law} out of range")
    if n_live is not None and not 1 <= n_live <= n:
        raise ValueError(f"n_live={n_live} outside [1, N={n}]")
    width = 0
    if store is not None:
        check_tensor(store, "store", torch.int32, 2, dev)
        if store.shape[0] != n or store.shape[1] == 0:
            raise ValueError(f"store {tuple(store.shape)} does not hold the "
                             f"N={n} rows of the index")
        width = store.shape[1]
    if n == 0 or d == 0 or n_tables == 0 or p == 0:
        raise ValueError(f"empty index or draws: x {tuple(x.shape)}, "
                         f"order {tuple(order.shape)}, P={p}")
    out = (torch.empty((b, m), dtype=torch.int64, device=dev),
           torch.empty((b, m), dtype=torch.float32, device=dev),
           torch.empty((b, m), dtype=torch.int32, device=dev),
           torch.empty((b, m), dtype=torch.int32, device=dev),
           torch.empty((b, m), dtype=torch.bool, device=dev),
           torch.empty((b, m), dtype=torch.int32, device=dev))
    rows = w = None
    if store is not None:
        rows = torch.empty((b * m, width), dtype=torch.int32, device=dev)
        w = torch.empty((b * m,), dtype=torch.float32, device=dev)
    if b * m == 0:
        return out + (rows, w)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _raise_on(_fn("draw_assemble_launch")(
        lo.data_ptr(), hi.data_ptr(), order.data_ptr(), x.data_ptr(),
        queries.data_ptr(), tables.data_ptr(), slot_u.data_ptr(),
        None if fallback_ids is None else fallback_ids.data_ptr(),
        ctypes.addressof(_host_popcounts(tuple(popcounts))),
        *((starts.data_ptr(), band_u.data_ptr(), fallback_u.data_ptr())
          if banded else (None, None, None)),
        None if store is None else store.data_ptr(),
        *(t.data_ptr() for t in out),
        None if rows is None else rows.data_ptr(),
        None if w is None else w.data_ptr(),
        b, m, p, j, n_tables, n, d, width, k, law, n_live or 0, nb, d_law,
        p_fallback, p_floor, stream), "draw_assemble")
    launches["draw_assemble"] += 1
    return out + (rows, w)
