"""ctypes wrapper of the CUDA SimHash kernel (``csrc/simhash.cu``).

Replaces the TPU kernel ``_simhash_kernel`` / ``simhash_codes_pallas``
(src/repro/kernels/simhash/kernel.py:53 / :76).  Bound on the H100: fp32
FMAs on CUDA cores (2·N·d·L·K operations; no TF32, for code parity).
The design — register tiles of BM rows x 128 columns of whole tables
(72 for a narrow group whose parts go across blocks), a cp.async
staging ring of 16-byte copies where the layouts allow, a whole-table
epilogue with table-major coalesced code writes, and the bucket probe's
sum order at every d (above 128 features, parts added in registers or,
their sums through scratch, across the blocks of a row tile in a
cooperative launch) — is set out at the top of the CUDA source.
``simhash_plan`` picks a launch in pure Python; the CUDA launcher
refuses one it does not take, and ``simhash_instance`` reports the
instantiation it runs.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import arrival_counts, check_tensor, launches, sm_count
from ..build import library

MAX_K = 32
# the CUDA launcher's rules for a plan
COLS = 128           # columns a block, whole tables
NARROW_COLS = 72     # columns a block of the narrow layout
FEAT_ONE = 128       # up to this many features, one sum
FEAT_PART = 64       # above it, features a part
MAX_RANKS = 16       # blocks sharing a row tile
ROWS = (128, 64, 32)  # rows a block
PART_ROWS = 64       # the most rows a block when d > FEAT_ONE (registers)
NARROW_ROWS = (128, 64)  # rows a block of the narrow layout
BLOCKS_PER_SM = 2    # the grid's aim where N allows it, and the most
                     # blocks an SM holds (128 registers a thread)
SCRATCH_CAP = 64 << 20   # bytes of part sums a split launch may take


class SimhashPlan(NamedTuple):
    """A launch: ``bm`` rows x ``tables`` whole tables of ``cols`` columns
    a block, ``groups`` table groups, ``parts`` feature parts, and
    ``ranks`` blocks sharing a row tile: 1 (every part in one block) or
    more (``split``), each taking ``pg`` parts, their sums through
    scratch; ``narrow``: a split's block computes NARROW_COLS columns
    from w as given, not COLS from a padded copy."""
    bm: int
    tables: int
    cols: int
    groups: int
    parts: int
    ranks: int
    tiles: int
    narrow: bool = False

    @property
    def split(self) -> bool:
        return self.ranks > 1

    @property
    def pg(self) -> int:
        return -(-self.parts // self.ranks)

    @property
    def blocks(self) -> int:
        return self.tiles * self.groups * self.ranks

    @property
    def scratch_floats(self) -> int:
        """Part sums of a split launch: [tile, group][parts][bm][cs], cs
        the group's columns rounded up to 8."""
        return (self.tiles * self.groups * self.parts * self.bm *
                -(-self.cols // 8) * 8 if self.split else 0)


def simhash_plan(n: int, d: int, l: int, k: int, sms: int) -> SimhashPlan:
    """The launch of ``simhash_codes_cuda`` for x (N, d), L tables of K bits
    on a card of ``sms`` SMs.

    A block covers the most whole tables that fit COLS columns, and the
    most rows of ROWS (at most PART_ROWS above FEAT_ONE features) that
    still give BLOCKS_PER_SM blocks per SM.  Up to FEAT_ONE features a
    block sums them all in order; above, parts of FEAT_PART features are
    added in part order (the probe's order): in registers when the row
    tiles fill the card, else split over the blocks of each row tile, as
    many (a power of 2, at most MAX_RANKS and the parts) as keep every
    block resident at BLOCKS_PER_SM an SM (a cooperative launch), with
    the rows that give the most blocks (of those, the most rows: the
    fewest copies of w), where the part sums fit SCRATCH_CAP.  A split
    whose group fits NARROW_COLS columns may also take the narrow layout
    (rows of NARROW_ROWS), where no warp computes padding alone; of
    splits with as many blocks it is preferred."""
    parts = 1 if d <= FEAT_ONE else -(-d // FEAT_PART)
    tables = max(1, min(l, COLS // k))
    groups = -(-l // tables)
    aim = BLOCKS_PER_SM * sms

    def plan(rows, ranks, narrow=False):
        return SimhashPlan(rows, tables, tables * k, groups, parts, ranks,
                           -(-n // rows), narrow)

    rows = ROWS if parts == 1 else tuple(r for r in ROWS if r <= PART_ROWS)
    regs = [plan(r, 1) for r in rows]
    reg = next((p for p in regs if p.blocks >= aim), regs[-1])
    if parts == 1 or reg.blocks >= aim:
        return reg
    layouts = [(r, False) for r in rows]
    if tables * k <= NARROW_COLS:
        layouts += [(r, True) for r in NARROW_ROWS]
    splits = []
    for r, narrow in layouts:
        tiles = plan(r, 1).blocks
        ranks = min(MAX_RANKS, parts, aim // tiles)
        if ranks >= 2:
            splits.append(plan(r, 1 << (ranks.bit_length() - 1), narrow))
    splits = [p for p in splits if p.scratch_floats * 4 <= SCRATCH_CAP]
    return max(splits, key=lambda p: (p.blocks, p.narrow, p.bm),
               default=reg)


def padded_projections(w: torch.Tensor, plan: SimhashPlan) -> torch.Tensor:
    """w (d, L*K) laid out as the kernel stages it: as given for a narrow
    plan, else so that a group's slice of a row is 16-byte aligned:
    (d, groups * COLS), group g's ``plan.cols`` columns at g * COLS (one
    strided copy, none when the groups are COLS wide and w is 16-byte
    aligned).  The columns after a group's are left unwritten: they only
    reach sign bits that the kernel masks off."""
    d, lk = w.shape
    g, cols = plan.groups, plan.cols
    if plan.narrow or g * COLS == lk and w.data_ptr() % 16 == 0:
        return w
    wp = torch.empty((d, g, COLS), dtype=w.dtype, device=w.device)
    if g * cols == lk:
        wp[:, :, :cols].copy_(w.view(d, g, cols))
    else:   # a last group of fewer tables
        wp[:, :g - 1, :cols].copy_(w[:, :(g - 1) * cols].view(d, g - 1, cols))
        wp[:, g - 1, :lk - (g - 1) * cols].copy_(w[:, (g - 1) * cols:])
    return wp.view(d, g * COLS)


@functools.cache
def _lib():
    lib = library("simhash")
    lib.simhash_codes_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int64] + [ctypes.c_int] * 8
        + [ctypes.c_void_p])
    lib.simhash_codes_launch.restype = ctypes.c_int
    lib.simhash_instance.argtypes = (
        [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_int] * 8
        + [ctypes.POINTER(ctypes.c_int)])
    lib.simhash_instance.restype = ctypes.c_int
    return lib


def simhash_instance(x: torch.Tensor, plan: SimhashPlan, l: int,
                     k: int) -> dict | None:
    """The kernel instantiation the CUDA launcher runs for ``plan`` on x
    (N, d) with L tables of K bits: rows a block, sum mode ("one",
    "reg_parts", "split_parts"), whether x is copied 16 bytes at a time,
    the narrow layout and its dynamic shared memory in bytes; None for a
    plan the launcher refuses."""
    n, d = x.shape
    info = (ctypes.c_int * 5)()
    if _lib().simhash_instance(x.data_ptr(), n, d, l, k, plan.bm,
                               plan.tables, plan.parts, plan.ranks,
                               int(plan.narrow), info):
        return None
    return dict(rows=info[0],
                mode=("one", "reg_parts", "split_parts")[info[1]],
                x16=bool(info[2]), narrow=bool(info[3]), smem=info[4])


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
    plan = simhash_plan(n, d, l, k, sm_count(x.device.index))
    wp = padded_projections(w, plan)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    part = arrived = None
    if plan.split:
        part = torch.empty(plan.scratch_floats, dtype=torch.float32,
                           device=x.device)
        arrived = arrival_counts(x.device, stream,
                                 2 * plan.tiles * plan.groups)
    err = _lib().simhash_codes_launch(
        x.data_ptr(), wp.data_ptr(), codes.data_ptr(),
        None if part is None else part.data_ptr(),
        None if arrived is None else arrived.data_ptr(), n, d, l, k,
        plan.bm, plan.tables, plan.parts, plan.ranks, int(plan.narrow),
        stream)
    if err != 0:
        raise RuntimeError(f"simhash kernel launch failed: CUDA error {err}")
    launches["simhash"] += 1
    return codes
