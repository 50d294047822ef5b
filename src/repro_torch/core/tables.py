"""The sorted-code LSH index (PyTorch port of ``repro.core.tables``).

  per table t:
    order[t, :]      stable argsort of the codes of table t    (L, N) int64
    sorted_codes[t]  codes[t, order[t]]                        (L, N) int64

A bucket is the contiguous slice [lo, hi) of a table's sorted codes that
equals the query's code.  Both halves of the hot path run hand-written
kernels on a card and plain PyTorch on the CPU:

  * build/refresh hashing: ``kernels.simhash`` (linear families; the
    quadratic family hashes with plain chunked quadratic forms, as the
    JAX package leaves it to XLA);
  * query probing: ``kernels.bucket_probe`` — per (query, probe, table)
    the bucket's bounds in ``sorted_codes``: on a card a warp-wide
    32-way search, on the CPU ``searchsorted``.

Sorts are stable (``torch.sort(stable=True)``), as ``jnp.argsort`` is,
so tie order — and with it ``order`` — matches the reference bitwise.

INDEX MUTATIONS.  Every index write goes through ``mutate_index(index,
IndexMutation(op, ...), params)``: the build, the full refresh, and the
``delta`` / ``append`` / ``evict`` merges, which are ONE tie-stable
merge (``_merge_impl``): the changed codes are scattered into their
previous sorted slots, then a stable sort is composed back through the
previous ``order``.  Unchanged rows keep their slots, appended rows
land after existing equal-code ties, and an all-rows delta is bitwise
a full warm refresh.

STREAMING / CAPACITY.  A streaming index has a power-of-two capacity C
(``grow_index`` adds empty slots); an empty slot carries ``EMPTY_CODE``,
which sorts after every live code (K <= 31), so the first ``n_live``
entries of every table's ``order`` are exactly the live ids — what the
sampler's live-count fallback draws from.

BANDED FAMILIES.  A banded family (``num_bands() > 1``) ORs each row's
band tag ``band << K`` into its codes where data codes are made
(``_hash_points``), so every band is one contiguous region of every
table.  ``band_starts`` recovers the regions on the device;
``bucket_bounds_banded`` probes every band's buckets in one launch.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.kernels.bucket_probe import (
    bucket_probe,
    bucket_probe_codes,
    bucket_probe_multi,
)
from repro_torch.kernels.simhash import simhash_codes

from .families import get_family
from .simhash import LSHParams, compute_codes, make_projections


class LSHIndex(NamedTuple):
    """Sorted-code LSH index over n points."""

    projections: torch.Tensor   # (d, L*K) or (L*K, d, d) for quadratic
    sorted_codes: torch.Tensor  # (L, N) int64, ascending per row
    order: torch.Tensor         # (L, N) int64: order[t, j] = original point id

    @property
    def n_tables(self) -> int:
        return self.sorted_codes.shape[0]

    @property
    def n_points(self) -> int:
        return self.sorted_codes.shape[1]


def _hash_points(x: torch.Tensor, proj: torch.Tensor,
                 params: LSHParams) -> torch.Tensor:
    """(N, d) augmented points -> (L, N) contiguous int64 codes.

    A banded family's per-row tags (``code_tags``) are ORed in here, the
    one place data codes are made, so build, refresh, delta and append
    all tag alike."""
    fam = get_family(params.family)
    if fam.proj_kind == "quadratic":
        codes = compute_codes(x, proj, k=params.k, l=params.l,
                              quadratic=True)
    else:
        codes = simhash_codes(x, proj, k=params.k, l=params.l)
    codes = codes.T.contiguous()  # a no-op copy for the kernel's (L, N) layout
    tags = fam.code_tags(x, params.k)
    if tags is not None:
        codes |= tags[None, :]
    return codes


# Sentinel code of an EMPTY capacity slot: every live code is < 2^32 - 1
# for K <= 31, so empty slots sort after all of them.
EMPTY_CODE = 0xFFFFFFFF


def _mask_codes(codes: torch.Tensor,
                live_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Force the codes of dead capacity slots to the sentinel."""
    if live_mask is None:
        return codes
    return torch.where(live_mask[None, :], codes,
                       torch.full_like(codes, EMPTY_CODE))


def _sort_rows(codes: torch.Tensor):
    """Stable per-table sort -> (sorted_codes, order)."""
    return torch.sort(codes, dim=1, stable=True)


def _build_impl(generator, projections, x_aug: torch.Tensor,
                params: LSHParams,
                live_mask: Optional[torch.Tensor]) -> LSHIndex:
    if params.dim != x_aug.shape[-1]:
        raise ValueError(
            f"params.dim={params.dim} != data dim {x_aug.shape[-1]}")
    proj = (make_projections(generator, params, x_aug.device)
            if projections is None else projections)
    codes = _mask_codes(_hash_points(x_aug, proj, params), live_mask)
    sorted_codes, order = _sort_rows(codes)
    return LSHIndex(proj, sorted_codes, order)


def _refresh_impl(index: LSHIndex, x_aug: torch.Tensor, params: LSHParams,
                  live_mask: Optional[torch.Tensor],
                  warm_start: bool) -> LSHIndex:
    codes = _mask_codes(_hash_points(x_aug, index.projections, params),
                        live_mask)
    if not warm_start:
        sorted_codes, order = _sort_rows(codes)
        return LSHIndex(index.projections, sorted_codes, order)
    # compose a stable sort of the codes permuted by the previous order:
    # ties keep their previous layout, unchanged codes keep their slots.
    prev = index.order
    permuted = torch.gather(codes, 1, prev)
    sorted_codes, delta = _sort_rows(permuted)
    return LSHIndex(index.projections, sorted_codes,
                    torch.gather(prev, 1, delta))


def _merge_impl(index: LSHIndex, ids: torch.Tensor,
                codes: torch.Tensor) -> LSHIndex:
    """The ONE tie-stable merge under delta / append / evict.

    ``ids`` (D,) point ids, ``codes`` (L, D) their new codes.  Scatter
    the codes into the ids' previous sorted slots (pos[t, order[t, j]]
    = j), then compose a stable sort back through the previous
    ``order``: entries are placed by (new code, previous position),
    bitwise what a full warm refresh computes when the other codes are
    unchanged.  Duplicate ids with equal code columns write equal
    values, a no-op (padding repeats an entry)."""
    order = index.order
    l, n = order.shape
    iota = torch.arange(n, dtype=order.dtype, device=order.device)
    pos = torch.empty_like(order).scatter_(1, order, iota.expand(l, n))
    pos_d = pos.index_select(1, ids.to(torch.int64))        # (L, D)
    permuted = index.sorted_codes.clone().scatter_(
        1, pos_d, codes.to(index.sorted_codes.dtype))
    sorted_codes, delta = _sort_rows(permuted)
    return LSHIndex(index.projections, sorted_codes,
                    torch.gather(order, 1, delta))


@dataclasses.dataclass(frozen=True, eq=False)
class IndexMutation:
    """ONE declarative description of an index write (see ``mutate_index``).

      * ``"build"``   — ``x_aug`` (C, d) and either ``generator`` (draws
        the projections) or ``projections`` (given — the hook the
        parity tests use to build on the reference's projections);
        optional ``live_mask`` (C,) bool under a managed capacity.
      * ``"refresh"`` — ``x_aug`` fresh (C, d) features (projections are
        reused); ``warm_start`` keeps tie layouts stable; optional
        ``live_mask``.
      * ``"delta"``   — ``ids`` (D,) + ``codes`` (L, D): merge the fresh
        codes of a dirty subset (duplicate ids with equal code columns
        are legal: padding repeats an entry).
      * ``"append"``  — ``ids`` (D,) previously EMPTY slots + ``codes``
        (L, D) of the new rows.
      * ``"evict"``   — ``ids`` (D,) live slots to empty (their codes
        become ``EMPTY_CODE``).

    ``tokens`` is a pipeline payload (the token rows of a pipeline
    append, which ``LSHSampledPipeline.mutate`` embeds and hashes);
    ``mutate_index`` never reads it.
    """

    op: str
    generator: Optional[torch.Generator] = None
    projections: Optional[torch.Tensor] = None
    x_aug: Optional[torch.Tensor] = None
    ids: Optional[torch.Tensor] = None
    codes: Optional[torch.Tensor] = None
    live_mask: Optional[torch.Tensor] = None
    warm_start: bool = True
    tokens: Optional[Any] = None

    _OPS = ("build", "refresh", "delta", "append", "evict")

    def __post_init__(self):
        if self.op not in self._OPS:
            raise ValueError(
                f"IndexMutation.op must be one of {self._OPS}, "
                f"got {self.op!r}")


def _require(mutation: IndexMutation, **fields):
    for name, value in fields.items():
        if value is None:
            raise ValueError(
                f"IndexMutation(op={mutation.op!r}) requires {name}")


def mutate_index(index: Optional[LSHIndex], mutation: IndexMutation,
                 params: Optional[LSHParams] = None) -> LSHIndex:
    """THE index write entry point: apply ``mutation``, return a new index
    (inputs are never written).

    ``params`` is needed by the hashing ops (``build`` / ``refresh``),
    not by the merges (``delta`` / ``append`` / ``evict``), whose payload
    is hashed codes.  Runs on the device of its tensors: the simhash
    kernel on a card, the plain version on the CPU.  Each op is a pure
    function of its inputs (and of the generator's state for a build).
    ``append`` / ``evict`` keep the delta merge's contract: unchanged
    rows keep their exact slots, appended rows land after existing
    equal-code ties, evicted rows join the sentinel tail in their
    previous relative order."""
    op = mutation.op
    if op == "build":
        _require(mutation, x_aug=mutation.x_aug, params=params)
        if mutation.generator is None and mutation.projections is None:
            raise ValueError(
                "IndexMutation(op='build') requires generator or projections")
        return _build_impl(mutation.generator, mutation.projections,
                           mutation.x_aug, params, mutation.live_mask)
    if index is None:
        raise ValueError(f"IndexMutation(op={op!r}) requires an index")
    if op == "refresh":
        _require(mutation, x_aug=mutation.x_aug, params=params)
        return _refresh_impl(index, mutation.x_aug, params,
                             mutation.live_mask, mutation.warm_start)
    if op in ("delta", "append"):
        _require(mutation, ids=mutation.ids, codes=mutation.codes)
        return _merge_impl(index, mutation.ids, mutation.codes)
    _require(mutation, ids=mutation.ids)                    # evict
    return evict_rows(index, mutation.ids)


def append_rows(index: LSHIndex, ids: torch.Tensor,
                codes: torch.Tensor) -> LSHIndex:
    """Merge new rows into previously EMPTY capacity slots: ``ids`` (D,)
    slots holding ``EMPTY_CODE``, ``codes`` (L, D) the rows' codes.  Pad
    D by repeating an entry.  Every live row keeps its slot; appended
    rows insert after existing equal-code ties."""
    return _merge_impl(index, ids, codes)


def evict_rows(index: LSHIndex, ids: torch.Tensor) -> LSHIndex:
    """Empty the given live slots (their codes become ``EMPTY_CODE``).
    Evicted slots join every table's sentinel tail; the remaining live
    rows keep their slots, so ``order[t, :n_live]`` stays a permutation
    of the live ids in every table t."""
    codes = torch.full((index.n_tables, ids.shape[0]), EMPTY_CODE,
                       dtype=index.sorted_codes.dtype,
                       device=index.sorted_codes.device)
    return _merge_impl(index, ids, codes)


def grow_index(index: LSHIndex, new_capacity: int) -> LSHIndex:
    """Grow a capacity-managed index to ``new_capacity`` slots: the new
    slots are EMPTY and join the tail of every table's sorted order in
    slot order (the sentinel is the largest code), so every existing
    row keeps its exact slot."""
    l, n = index.order.shape
    if new_capacity < n:
        raise ValueError(
            f"new_capacity={new_capacity} < current capacity {n} "
            "(shrink by compaction at the store level, not here)")
    if new_capacity == n:
        return index
    pad = new_capacity - n
    sc = index.sorted_codes
    sorted_codes = torch.cat(
        [sc, torch.full((l, pad), EMPTY_CODE, dtype=sc.dtype,
                        device=sc.device)], dim=1)
    extra = torch.arange(n, new_capacity, dtype=index.order.dtype,
                         device=index.order.device).expand(l, pad)
    return LSHIndex(index.projections, sorted_codes,
                    torch.cat([index.order, extra], dim=1))


def hash_points(x: torch.Tensor, proj: torch.Tensor,
                params: LSHParams) -> torch.Tensor:
    """Public (L, N)-layout hashing entry."""
    return _hash_points(x, proj, params)


def query_codes(index: LSHIndex, q: torch.Tensor,
                params: LSHParams) -> torch.Tensor:
    """Hash a query (d,) or batch (m, d) -> (L,) or (m, L) int64."""
    return compute_codes(
        q, index.projections, k=params.k, l=params.l,
        quadratic=get_family(params.family).proj_kind == "quadratic")


def bucket_bounds(index: LSHIndex, qcodes: torch.Tensor):
    """For each table, the [lo, hi) slice of the query's bucket.

    qcodes: (L,) int64 -> lo, hi: (L,) int32, from ``bucket_probe_codes``
    (the kernel on a card)."""
    return bucket_probe_codes(qcodes, index.sorted_codes)


def bucket_bounds_batched(index: LSHIndex, queries: torch.Tensor,
                          params: LSHParams):
    """Hash + probe for a query batch (B, d) (or a single (d,)).

    Returns (lo, hi) int32 of shape (B, L) — or (L,) for a 1-D query.
    Linear families run the fused ``bucket_probe`` kernel on a card;
    the quadratic family hashes with plain quadratic forms and probes
    with ``bucket_probe_codes``.

    There is no cutover by N/B: the JAX package's
    ``COUNTING_PROBE_MAX_POINTS_PER_QUERY`` bounds the TPU kernel, which
    streams all L*N codes per call.  The Hopper kernel searches, a warp
    per (query, table) with 32 pivots a round, so its cost grows with
    the rounds, log_33 N (4 at N 463,715), and every CUDA tensor takes
    it.
    """
    if get_family(params.family).proj_kind == "quadratic":
        return bucket_probe_codes(query_codes(index, queries, params),
                                  index.sorted_codes)
    return bucket_probe(queries, index.projections, index.sorted_codes,
                        k=params.k, l=params.l)


def bucket_bounds_multi(index: LSHIndex, queries: torch.Tensor,
                        params: LSHParams, masks: tuple):
    """Bucket bounds for the full multi-probe code sequence.

    For every query, table t and probe mask ``masks[j]``, the [lo, hi)
    slice of the bucket whose code is ``code(q)[t] ^ masks[j]``.

    Returns (lo, hi) int32 of shape (B, J, L) — or (J, L) for a 1-D query.
    Linear families run the fused multi-probe kernel; the quadratic
    family probes its J·L perturbed codes with ``bucket_probe_codes``.
    """
    if get_family(params.family).proj_kind != "quadratic":
        return bucket_probe_multi(queries, index.projections,
                                  index.sorted_codes, tuple(masks),
                                  k=params.k, l=params.l)
    qcodes = query_codes(index, queries, params)            # (..., L)
    squeeze = qcodes.dim() == 1
    if squeeze:
        qcodes = qcodes[None]
    marr = torch.tensor(list(masks), dtype=torch.int64, device=qcodes.device)
    pcodes = qcodes[:, None, :] ^ marr[None, :, None]       # (B, J, L)
    b, j, l = pcodes.shape
    lo, hi = bucket_probe_codes(pcodes.reshape(b * j, l), index.sorted_codes)
    lo, hi = lo.reshape(b, j, l), hi.reshape(b, j, l)
    return (lo[0], hi[0]) if squeeze else (lo, hi)


# -- banded (norm-ranged) probing ------------------------------------------


def band_starts(index: LSHIndex, params: LSHParams) -> torch.Tensor:
    """(num_bands + 1,) int32 start of each band's region in the sorted
    order: ``starts[j] <= i < starts[j+1]`` iff sorted slot i holds a
    band-j row, in every table (each sorts the same per-row tags), so a
    search of table 0 for the edges ``j << K`` finds them.  ``starts[-1]``
    is the live count: the last edge ``num_bands << K`` is at most
    2^code_width <= 2^31, below the ``EMPTY_CODE`` tail.  Stays on the
    index's device; nothing reads it on the host."""
    nb = get_family(params.family).num_bands()
    sc = index.sorted_codes
    edges = torch.arange(1, nb + 1, dtype=sc.dtype, device=sc.device) \
        << params.k
    starts = torch.searchsorted(sc[0], edges).to(torch.int32)
    return torch.cat([torch.zeros((1,), dtype=torch.int32,
                                  device=sc.device), starts])


@functools.lru_cache(maxsize=64)
def _band_probe_bits(masks: tuple, nb: int, k: int, device: torch.device):
    """(J,) probe masks and (nb,) band tags ``j << K`` as int64 on
    ``device``, made once: a host-to-card copy every call would block
    the host."""
    return (torch.tensor(masks, dtype=torch.int64, device=device),
            torch.arange(nb, dtype=torch.int64, device=device) << k)


def bucket_bounds_banded(index: LSHIndex, queries: torch.Tensor,
                         params: LSHParams, masks: tuple):
    """Multi-probe bucket bounds in EVERY band of a banded index.

    The query hashes untagged (its band coordinate is 0 and that
    projection row is zeroed), so band j's probe codes are
    ``(code(q)[t] ^ masks[p]) | (j << K)``.  All ``num_bands·J·L`` probe
    codes of every query go through ``bucket_probe_codes`` in one
    launch.

    Returns (lo, hi) int32 of shape (B, num_bands, J, L), or
    (num_bands, J, L) for a single (d,) query."""
    nb = get_family(params.family).num_bands()
    qcodes = query_codes(index, queries, params)            # (..., L)
    squeeze = qcodes.dim() == 1
    if squeeze:
        qcodes = qcodes[None]
    marr, tags = _band_probe_bits(tuple(masks), nb, params.k, qcodes.device)
    pcodes = ((qcodes[:, None, None, :] ^ marr[None, None, :, None])
              | tags[None, :, None, None])                  # (B, nb, J, L)
    b, _, j, l = pcodes.shape
    lo, hi = bucket_probe_codes(pcodes.reshape(b * nb * j, l),
                                index.sorted_codes)
    lo, hi = lo.reshape(b, nb, j, l), hi.reshape(b, nb, j, l)
    return (lo[0], hi[0]) if squeeze else (lo, hi)
