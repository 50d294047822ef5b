"""Algorithm 1 of the paper: LSH sampling with exact sampling probability.

PyTorch port of ``repro.core.sampler`` (``sample``, ``sample_batched``,
``sample_drain``, ``sample_gather``, ``sample_gather_batched``).

* ``sample`` — m independent repetitions of the paper's single-sample
  Algorithm 1: each repetition draws tables with replacement until a
  non-empty bucket is found (l = #probes), samples uniformly inside the
  bucket, and reports
      p = cp(x, q)^K * (1 - cp(x, q)^K)^(l-1) / |S_b|.
* ``sample_batched`` — ``sample`` for B queries at once: one probe
  kernel launch hashes all B queries and finds all B·J·L buckets.
* ``sample_drain`` (Appendix B.2) — the whole minibatch from the first
  non-empty bucket.
* ``sample_gather`` / ``sample_gather_batched`` — the LM training step's
  batch draw: Algorithm 1, then the token rows and their 1/(p·N)
  weights from the device-resident store.

``max_probes`` caps the table draws; if every probed bucket is empty
the sample falls back to a uniform draw with p = 1/N (flagged), which
keeps the estimator unbiased.  On a streaming index (``n_live``, the
host's live count) the fallback draws a slot u < n_live and takes
``order[0, u]`` — the live ids fill every table's first n_live sorted
slots — with p = 1/n_live, and the weights are 1/(p·n_live).  With
``multiprobe > 0`` each table draw walks ``J = 1 + multiprobe``
Hamming-ball probe codes before the next draw, and the probability is
corrected for the walk:

    p = q_{r_j} * (1 - Q)^(l-1) / |S_b|,      Q = sum_{i<J} q_{r_i}.

BANDED FAMILIES (``mips_banded``).  Every band is probed in one launch
(``tables.bucket_bounds_banded``); each repetition draws a band with
probability n_band / total from the device-side ``band_starts``, walks
that band's buckets, and reports p = (n_band/total) · q_r ·
(1 - Q)^(l-1) / |S_b|; its fallback is uniform over the live prefix
with p = 1/total.  On a card this is ``draw_assemble``'s band mode, the
same single launch.

RANDOM DRAWS.  Every random number a call uses is in one
``SampleDraws``: the table drawn at each probe, the within-bucket
uniform and the fallback id of every repetition, and for a banded
family the band and fallback uniforms.  By default they come
from the caller's ``torch.Generator``; a caller may pass them instead
(``draws=``).  The parity tests do that with the reference's own draws,
rebuilt from the same JAX key, because torch's Philox and JAX's
threefry never give the same bits.

ONE LAUNCH AFTER THE PROBE.  On a card everything after the probe —
the candidate walk, the slot, the id, the collision probability, p and,
for ``sample_gather*``, the row gather and the weight — is one
``draw_assemble`` kernel launch (``draw_assemble``), as the reference
runs it inside one jitted program.  On the CPU the same function is its
plain composition, ``draw_assemble_plain``: ``_sample_rows`` (the m and
B repetitions as one batch of tensor operations, the reference's
``vmap`` written out), then ``gather_weight_ref``.  Neither syncs with
the host.  ``sample_drain`` is plain everywhere.
"""

from __future__ import annotations

import operator
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import any_dtensor, on_cuda
from repro_torch.kernels.gather_weight import (
    draw_assemble_cuda, gather_weight_ref, law_code)

from .families import get_family
from .simhash import LSHParams, probe_masks
from .tables import (
    LSHIndex,
    band_starts,
    bucket_bounds_banded,
    bucket_bounds_batched,
    bucket_bounds_multi,
)


class SampleResult(NamedTuple):
    indices: torch.Tensor       # (..., m) int64 — sampled point ids
    probs: torch.Tensor         # (..., m) f32   — Alg. 1 probability
    n_probes: torch.Tensor      # (..., m) int32 — l, tables probed
    bucket_sizes: torch.Tensor  # (..., m) int32 — |S_b| of chosen bucket
    fallback: torch.Tensor      # (..., m) bool  — uniform fallback used
    probe_code: torch.Tensor    # (..., m) int32 — winning probe index
    #                             (0 = exact bucket, -1 = uniform fallback)


class GatherBatch(NamedTuple):
    """One assembled device-resident LGD batch (all fields (m, ...))."""

    tokens: torch.Tensor        # (m, S) int32 — input token rows
    targets: torch.Tensor       # (m, S) int32 — next-token targets
    loss_weights: torch.Tensor  # (m,) f32 — 1/(p·N), optionally mean-1
    example_ids: torch.Tensor   # (m,) int64 — global ids (offset applied)
    indices: torch.Tensor       # (m,) int64 — store-local sampled row ids
    probs: torch.Tensor         # (m,) f32 — raw Algorithm-1 probabilities
    fallback: torch.Tensor      # (m,) bool — uniform-fallback flags
    probe_code: torch.Tensor    # (m,) int32 — winning probe index
    #                             (0 = exact bucket, -1 = fallback)


class SampleDraws(NamedTuple):
    """The random numbers of one sampling call (see module docstring)."""

    tables: torch.Tensor    # (..., m, max_probes) int64 in [0, L)
    slot_u: torch.Tensor    # (..., m) float32 in [0, 1)
    fallback: Optional[torch.Tensor]  # (..., m) int64 in [0, N): an id;
    #   with n_live in [0, n_live): a slot of order[0, :n_live]; None for
    #   a banded family, whose fallback is ``fallback_u``
    # banded families only: the live count is a device value there, so
    # the band and the fallback slot are drawn as floor(u * total)
    band_u: Optional[torch.Tensor] = None      # (..., m) float32 in [0, 1)
    fallback_u: Optional[torch.Tensor] = None  # (..., m) float32 in [0, 1)

    def map(self, fn) -> "SampleDraws":
        """``fn`` applied to every field that is not None."""
        return SampleDraws(*(None if f is None else fn(f) for f in self))

    def to(self, device) -> "SampleDraws":
        return self.map(lambda f: f.to(device))


def draw_samples(generator: torch.Generator, shape: tuple, max_probes: int,
                 n_tables: int, n_points: int, device,
                 bands: bool = False) -> SampleDraws:
    """Draw ``SampleDraws`` for repetitions of the given ``shape``
    ((m,) for ``sample``, (B, m) for ``sample_batched``); ``bands``
    draws the banded draw's ``band_u`` and ``fallback_u`` in place of the
    fallback id."""
    if generator is None:
        raise ValueError("sampling needs a torch.Generator or explicit draws")
    shape = tuple(shape)
    tables = torch.randint(0, n_tables, shape + (max_probes,),
                           generator=generator, device=device)
    slot_u = torch.rand(shape, generator=generator, device=device)
    if not bands:
        return SampleDraws(tables, slot_u, torch.randint(
            0, n_points, shape, generator=generator, device=device))
    return SampleDraws(
        tables, slot_u, None,
        band_u=torch.rand(shape, generator=generator, device=device),
        fallback_u=torch.rand(shape, generator=generator, device=device))


def _uniform_below(u: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """Uniform integer in [0, bound) from u in [0, 1): floor(u * bound).

    Not ``randint(0, N) % bound``, which over-weights small residues
    whenever bound does not divide N; the min() guards the u -> 1 edge."""
    slot = torch.floor(u * bound.to(torch.float32)).to(torch.int64)
    return torch.minimum(slot, bound.to(torch.int64) - 1)


def popcounts(masks: tuple, device) -> torch.Tensor:
    """Float popcount r of each probe mask (its probe class)."""
    return torch.tensor([bin(m).count("1") for m in masks],
                        dtype=torch.float32, device=device)


def _check_draws(draws: SampleDraws, lo, n_tables: int, max_probes: int,
                 j_codes: int, starts=None) -> None:
    b, _, p = draws.tables.shape
    bands = () if starts is None else (starts.shape[0] - 1,)
    if lo.shape != (b,) + bands + (j_codes, n_tables) or p != max_probes:
        raise ValueError(
            f"draws {tuple(draws.tables.shape)} do not match bounds "
            f"{tuple(lo.shape)} and max_probes={max_probes}")
    if starts is not None and (draws.band_u is None
                               or draws.fallback_u is None):
        raise ValueError("a banded draw needs band_u and fallback_u")
    if starts is None and draws.fallback is None:
        raise ValueError("a flat draw needs fallback ids")


def _live_count(n_live) -> Optional[int]:
    """``n_live`` as a host int (or None).  A tensor is refused: reading a
    device scalar on the host would sync every step, and the pipeline
    knows its live count on the host."""
    if n_live is None:
        return None
    if isinstance(n_live, torch.Tensor):
        raise TypeError("n_live must be a Python int (the host's live "
                        "count), not a tensor")
    return operator.index(n_live)


def _sample_rows(draws: SampleDraws, lo, hi, order, x_aug, queries,
                 params: LSHParams, max_probes: int,
                 masks: tuple, n_live: Optional[int] = None,
                 starts: Optional[torch.Tensor] = None) -> SampleResult:
    """Algorithm 1 for a batch of queries given their bucket bounds: the
    port's one plain version of it.

    ``lo``/``hi`` are (B, J, L) — bucket bounds of the J Hamming-ball
    probe codes per table; ``queries`` (B, d); draws (B, m, ...).  Each
    of the ``max_probes`` table draws walks the probe sequence in order;
    the first non-empty bucket in (table-draw, probe) order wins.  With
    ``n_live`` the fallback is ``order[0, draws.fallback]`` with
    p = 1/n_live.

    BANDED (``starts``, the (nb + 1,) ``tables.band_starts``; ``lo``/``hi``
    (B, nb, J, L)): each repetition first draws a band with probability
    n_band / total, total = starts[-1] the live count, as the slot
    floor(band_u · total) searched in ``starts``; walks that band's
    bounds; and reports p = (n_band/total) · q_r · (1-Q)^(l-1) / |S_b|
    (the multi-probe form at every J, as the reference's
    ``_sample_one_banded``).  Its fallback is
    ``order[0, floor(fallback_u · total)]`` with p = 1/total; ``n_live``
    is not read.
    """
    n_tables, n_points = order.shape
    j_codes = len(masks)
    _check_draws(draws, lo, n_tables, max_probes, j_codes, starts)
    ts = draws.tables                                        # (B, m, P)
    b, m, p = ts.shape
    bidx = torch.arange(b, device=ts.device)[:, None]
    if starts is None:
        # every repetition of a query walks its query's bounds
        lo_r = lo[:, None].expand(b, m, j_codes, n_tables)
        sizes_r = (hi - lo)[:, None].expand(b, m, j_codes, n_tables)
    else:
        starts = starts.to(torch.int64)
        total = starts[-1]
        u = _uniform_below(draws.band_u, total)
        band = torch.searchsorted(starts[1:].contiguous(), u, right=True)
        n_band = starts[band + 1] - starts[band]
        lo_r = lo[bidx, band]                                # (B, m, J, L)
        sizes_r = hi[bidx, band] - lo_r
    # sz[b, r, j, i] = sizes_r[b, r, j, ts[b, r, i]]
    sz = torch.gather(sizes_r, 3,
                      ts[:, :, None, :].expand(b, m, j_codes, p))
    nonempty = (sz > 0).transpose(2, 3).reshape(b, m, p * j_codes)
    pos = torch.arange(p * j_codes, device=ts.device)
    first = torch.where(nonempty, pos, p * j_codes).amin(-1)  # (B, m)
    found = first < p * j_codes
    first = torch.where(found, first, 0)
    i = first // j_codes                                     # table-draw index
    pj = first % j_codes                                     # probe index
    t = torch.gather(ts, 2, i[..., None])[..., 0]
    l = i + 1

    ridx = torch.arange(m, device=ts.device)[None, :]
    size_raw = sizes_r[bidx, ridx, pj, t]
    size = torch.clamp(size_raw, min=1)
    slot = lo_r[bidx, ridx, pj, t] + _uniform_below(draws.slot_u, size)
    # an unfound repetition's slot may sit past the end; its id is
    # replaced by the fallback below, so clamp only to keep it in range
    idx = order[t, torch.clamp(slot, max=n_points - 1)]
    if starts is not None:
        fb_idx = order[0, _uniform_below(draws.fallback_u, total)]
        p_fb = 1.0 / total.to(torch.float32)
    elif n_live is None:
        fb_idx, p_fb = draws.fallback, 1.0 / n_points
    else:
        fb_idx, p_fb = order[0, draws.fallback], 1.0 / n_live
    idx = torch.where(found, idx, fb_idx)

    fam = get_family(params.family)
    cp = fam.collision_prob(x_aug[idx], queries[:, None, :])  # (B, m)
    if j_codes == 1 and starts is None:
        cpk = cp ** params.k
        p_lsh = cpk * (1.0 - cpk) ** (l - 1) / size.to(torch.float32)
    else:
        # q_r per probed mask; the J buckets of one table are disjoint,
        # so the per-table miss probability is 1 - sum(q).
        q_all = fam.probe_class_probs(cp[..., None], params.k,
                                      popcounts(masks, cp.device))
        miss = torch.clamp(1.0 - q_all.sum(-1), min=0.0)
        q_win = torch.gather(q_all, -1, pj[..., None])[..., 0]
        if starts is not None:
            p_band = n_band.to(torch.float32) / total.to(torch.float32)
            q_win = p_band * q_win
        p_lsh = q_win * miss ** (l - 1) / size.to(torch.float32)
    probs = torch.where(found, p_lsh, p_fb).to(torch.float32)
    return SampleResult(
        indices=idx,
        probs=probs,
        n_probes=torch.where(found, l, max_probes).to(torch.int32),
        bucket_sizes=torch.where(found, size_raw, 0).to(torch.int32),
        fallback=~found,
        probe_code=torch.where(found, pj, -1).to(torch.int32),
    )


def draw_assemble_plain(draws: SampleDraws, lo, hi, order, x_aug, queries,
                        params: LSHParams, max_probes: int, masks: tuple,
                        store: Optional[torch.Tensor] = None,
                        p_floor: float = 1e-8,
                        n_live: Optional[int] = None,
                        starts: Optional[torch.Tensor] = None):
    """The plain version of ``draw_assemble`` on any device:
    ``_sample_rows``, then with a store ``gather_weight_ref``."""
    n_live = _live_count(n_live)
    res = _sample_rows(draws, lo, hi, order, x_aug, queries, params,
                       max_probes, masks, n_live, starts)
    if store is None:
        return res, None, None
    rows, w = gather_weight_ref(store, res.indices.reshape(-1),
                                res.probs.reshape(-1), p_floor=p_floor,
                                n_rows=n_live)
    return res, rows, w


def draw_assemble(draws: SampleDraws, lo, hi, order, x_aug, queries,
                  params: LSHParams, max_probes: int, masks: tuple,
                  store: Optional[torch.Tensor] = None,
                  p_floor: float = 1e-8, n_live: Optional[int] = None,
                  starts: Optional[torch.Tensor] = None):
    """Algorithm 1 after the probe for (B, m) repetitions, and with a
    token ``store`` (N, W) int32 also the (B·m, W) rows and their weights
    1/(max(p, p_floor)·N) — N = ``n_live`` on a streaming index.

    Arguments as ``_sample_rows`` (``starts`` and (B, nb, J, L) bounds
    for a banded family).  Returns (``SampleResult`` with fields (B, m),
    rows or None, weights or None).  CUDA tensors take the
    ``draw_assemble`` kernel, one launch (a family whose collision law
    the kernel does not know raises); CPU tensors take
    ``draw_assemble_plain``.  DTensor arguments (the mesh-replicated
    store and index): the whole draw on every rank, replicated DTensors
    out."""
    if any_dtensor(lo, hi, order, x_aug, queries, store, starts,
                   *draws):
        from repro_torch.dist.sharding import replicated_call
        return replicated_call(draw_assemble, draws, lo, hi, order, x_aug,
                               queries, params, max_probes, masks, store,
                               p_floor, n_live, starts)
    n_live = _live_count(n_live)
    if not on_cuda(queries):
        return draw_assemble_plain(draws, lo, hi, order, x_aug, queries,
                                   params, max_probes, masks, store, p_floor,
                                   n_live, starts)
    _check_draws(draws, lo, order.shape[0], max_probes, len(masks), starts)
    fam = get_family(params.family)
    band = {}
    if starts is not None:
        band = dict(starts=starts.to(torch.int32).contiguous(),
                    band_u=draws.band_u.to(torch.float32).contiguous(),
                    fallback_u=draws.fallback_u.to(torch.float32)
                    .contiguous())
    out = draw_assemble_cuda(
        lo.to(torch.int32).contiguous(), hi.to(torch.int32).contiguous(),
        order.contiguous(),
        x_aug.to(torch.float32).contiguous(),
        queries.to(torch.float32).contiguous(),
        draws.tables.to(torch.int64).contiguous(),
        draws.slot_u.to(torch.float32).contiguous(),
        None if starts is not None else
        draws.fallback.to(torch.int64).contiguous(),
        tuple(bin(mk).count("1") for mk in masks), k=params.k,
        law=law_code(fam), d_law=fam.law_dim(x_aug.shape[1]),
        p_fallback=1.0 / (order.shape[1] if n_live is None else n_live),
        store=store, p_floor=p_floor, n_live=n_live, **band)
    return SampleResult(*out[:6]), out[6], out[7]


def _probe_bounds(index, queries, params, masks):
    """(…, J, L) bucket bounds for the probe sequence."""
    if len(masks) == 1:
        lo, hi = bucket_bounds_batched(index, queries, params)
        return lo[..., None, :], hi[..., None, :]
    return bucket_bounds_multi(index, queries, params, masks)


def _draw_one(generator, index: LSHIndex, x_aug, query, params: LSHParams,
              m: int, max_probes: Optional[int], multiprobe: int,
              draws: Optional[SampleDraws], store=None, p_floor=1e-8,
              n_live=None):
    """``draw_assemble`` for one query (d,): (result (m,), rows, w)."""
    res, rows, w = _draw_batch(
        generator, index, x_aug, query[None], params, m, max_probes,
        multiprobe, None if draws is None else draws.map(lambda d: d[None]),
        store, p_floor, n_live)
    return SampleResult(*(f[0] for f in res)), rows, w


def _draw_batch(generator, index: LSHIndex, x_aug, queries,
                params: LSHParams, m: int, max_probes: Optional[int],
                multiprobe: int, draws: Optional[SampleDraws], store=None,
                p_floor=1e-8, n_live=None):
    """``draw_assemble`` for queries (B, d): (result (B, m), rows, w).

    A banded family probes every band (``bucket_bounds_banded``, one
    launch) and draws in band mode with ``band_starts``; the banded draw
    reads no ``n_live`` (the starts' total is the live count), but the
    weights' N stays ``n_live``, as in the reference."""
    n_live = _live_count(n_live)
    max_probes = max_probes or max(2 * params.l, 8)
    masks = probe_masks(params.k, 1 + multiprobe)
    banded = get_family(params.family).num_bands() > 1
    if draws is None:
        draws = draw_samples(
            generator, (queries.shape[0], m), max_probes, index.n_tables,
            index.n_points if n_live is None else n_live, x_aug.device,
            bands=banded)
    if banded:
        lo, hi = bucket_bounds_banded(index, queries, params,
                                      masks)               # (B, nb, J, L)
        starts = band_starts(index, params)
    else:
        lo, hi = _probe_bounds(index, queries, params, masks)  # (B, J, L)
        starts = None
    return draw_assemble(draws, lo, hi, index.order, x_aug, queries, params,
                         max_probes, masks, store, p_floor, n_live, starts)


def sample(
    generator: Optional[torch.Generator],
    index: LSHIndex,
    x_aug: torch.Tensor,
    query: torch.Tensor,
    params: LSHParams,
    m: int = 1,
    max_probes: Optional[int] = None,
    multiprobe: int = 0,
    draws: Optional[SampleDraws] = None,
    n_live: Optional[int] = None,
) -> SampleResult:
    """m independent LSH samples for one query (paper Algorithm 1 x m).

    Args:
      generator: draws the random numbers (unused when ``draws`` given).
      index / x_aug: the LSH index and the (N, d) hashed vectors.
      query: (d,) query vector.
      params: hash-family hyper-parameters.
      m: number of independent repetitions.
      max_probes: cap on table draws per repetition (default max(2L, 8)).
      multiprobe: ADDITIONAL Hamming-ball probe codes walked per table.
      draws: explicit ``SampleDraws`` with fields shaped (m, ...).
      n_live: a streaming index's live count (a host int): the uniform
        fallback draws from the live prefix ``order[0, :n_live]`` with
        p = 1/n_live.  None keeps the dense-index path.

    Returns:
      ``SampleResult`` with every field shaped (m,); ``1/(probs * N)``
      importance weights are unbiased.
    """
    return _draw_one(generator, index, x_aug, query, params, m, max_probes,
                     multiprobe, draws, n_live=n_live)[0]


def sample_batched(
    generator: Optional[torch.Generator],
    index: LSHIndex,
    x_aug: torch.Tensor,
    queries: torch.Tensor,          # (B, d)
    params: LSHParams,
    m: int = 1,
    max_probes: Optional[int] = None,
    multiprobe: int = 0,
    draws: Optional[SampleDraws] = None,
    n_live: Optional[int] = None,
) -> SampleResult:
    """Algorithm 1 for B queries at once; every field comes back (B, m).

    One probe-kernel launch hashes all B queries and finds all B·J·L
    bucket slices; each (query, repetition) pair is an independent,
    exact-probability sample.  ``draws`` fields are shaped (B, m, ...);
    ``n_live`` as in ``sample``.
    """
    if queries.dim() != 2:
        raise ValueError(
            f"sample_batched expects queries (B, d), got "
            f"{tuple(queries.shape)}; use sample() for a single query")
    return _draw_batch(generator, index, x_aug, queries, params, m,
                       max_probes, multiprobe, draws, n_live=n_live)[0]


def sample_drain(
    generator: Optional[torch.Generator],
    index: LSHIndex,
    x_aug: torch.Tensor,
    query: torch.Tensor,
    params: LSHParams,
    m: int = 1,
    max_probes: Optional[int] = None,
    draws: Optional[SampleDraws] = None,
) -> SampleResult:
    """Appendix B.2: draw the whole minibatch from the first non-empty
    bucket.  ``draws``: tables (max_probes,), slot_u (m,), fallback (m,).
    Banded families are refused, as in the reference."""
    if get_family(params.family).num_bands() > 1:
        raise ValueError(
            "sample_drain does not support banded (norm-ranged) families: "
            "the drain scheme reuses ONE bucket for the whole minibatch, "
            "which cannot compose the per-draw band-selection probability; "
            "use sample()/sample_batched() with family "
            f"{params.family!r}")
    max_probes = max_probes or max(2 * params.l, 8)
    n_tables, n_points = index.order.shape
    if draws is None:
        if generator is None:
            raise ValueError(
                "sampling needs a torch.Generator or explicit draws")
        dev = x_aug.device
        draws = SampleDraws(
            torch.randint(0, n_tables, (max_probes,), generator=generator,
                          device=dev),
            torch.rand((m,), generator=generator, device=dev),
            torch.randint(0, n_points, (m,), generator=generator,
                          device=dev))
    lo, hi = bucket_bounds_batched(index, query, params)    # (L,)
    sizes = hi - lo
    ts = draws.tables
    nonempty = sizes[ts] > 0
    pos = torch.arange(max_probes, device=ts.device)
    first = torch.where(nonempty, pos, max_probes).amin()
    found = first < max_probes
    j = torch.where(found, first, 0)
    t = ts[j]
    l = j + 1
    size = torch.clamp(sizes[t], min=1)

    slots = lo[t] + _uniform_below(draws.slot_u, size)
    idx = index.order[t, torch.clamp(slots, max=n_points - 1)]
    idx = torch.where(found, idx, draws.fallback)

    cp = get_family(params.family).collision_prob(x_aug[idx], query)
    cpk = cp ** params.k
    p_lsh = cpk * (1.0 - cpk) ** (l - 1) / size.to(torch.float32)
    probs = torch.where(found, p_lsh, 1.0 / n_points).to(torch.float32)

    def full(v):   # one 0-d result, repeated for the m draws
        return torch.broadcast_to(v, (m,)).to(torch.int32)

    return SampleResult(
        indices=idx,
        probs=probs,
        n_probes=full(torch.where(found, l, max_probes)),
        bucket_sizes=full(torch.where(found, sizes[t], 0)),
        fallback=torch.broadcast_to(~found, (m,)),
        probe_code=full(torch.where(found, 0, -1)),
    )


def _assemble(res: SampleResult, rows: torch.Tensor, w: torch.Tensor,
              example_offset: int, normalize: bool,
              row_width: Optional[int]) -> GatherBatch:
    """A ``GatherBatch`` of one draw (m,) from its gathered rows and
    1/(p·N) weights."""
    if normalize:
        w = w / torch.clamp(w.mean(), min=1e-30)
    # row_width: the logical S+1 of the rows (the whole store row unless
    # a caller says otherwise)
    sw = rows.shape[1] if row_width is None else row_width
    return GatherBatch(
        tokens=rows[:, :sw - 1],
        targets=rows[:, 1:sw],
        loss_weights=w,
        example_ids=res.indices + example_offset,
        indices=res.indices,
        probs=res.probs,
        fallback=res.fallback,
        probe_code=res.probe_code,
    )


def sample_gather(
    generator: Optional[torch.Generator],
    index: LSHIndex,
    x_aug: torch.Tensor,
    query: torch.Tensor,
    store: torch.Tensor,            # (N, S+1) int32 device-resident rows
    params: LSHParams,
    m: int = 1,
    example_offset: int = 0,
    max_probes: Optional[int] = None,
    multiprobe: int = 0,
    p_floor: float = 1e-8,
    normalize: bool = True,
    row_width: Optional[int] = None,
    n_live=None,
    draws: Optional[SampleDraws] = None,
) -> GatherBatch:
    """The device-resident LGD batch draw: Algorithm 1 + gather + weights.

    Args as in ``sample``, plus:
      store: (N, S+1) int32 token rows on the index's device.
      example_offset: lifts store-local row ids to global example ids.
      p_floor: probability floor inside the weight computation.
      normalize: rescale weights to mean 1 over the batch.
      row_width: logical S+1 when it is narrower than the store rows.
      n_live: a capacity-managed store's live count (a host int): the
        fallback draws from the live prefix with p = 1/n_live and every
        weight is 1/(p·n_live), so the estimator stays unbiased over the
        live window.

    Returns a ``GatherBatch`` with every field shaped (m, ...).  Nothing
    syncs with the host.
    """
    res, rows, w = _draw_one(generator, index, x_aug, query, params, m,
                             max_probes, multiprobe, draws, store, p_floor,
                             n_live)
    return _assemble(res, rows, w, example_offset, normalize, row_width)


def sample_gather_batched(
    generator: Optional[torch.Generator],
    index: LSHIndex,
    x_aug: torch.Tensor,
    queries: torch.Tensor,          # (C, d)
    store: torch.Tensor,            # (N, S+1) int32
    params: LSHParams,
    m: int = 1,
    example_offset: int = 0,
    max_probes: Optional[int] = None,
    multiprobe: int = 0,
    p_floor: float = 1e-8,
    normalize: bool = True,
    row_width: Optional[int] = None,
    n_live=None,
    draws: Optional[SampleDraws] = None,
) -> GatherBatch:
    """``sample_gather`` for C queries at once; every field comes back
    (C, m, ...).  On a card the C·m draws, rows and weights are ONE
    ``draw_assemble`` launch, and weight normalisation is per chain.
    ``draws`` fields are shaped (C, m, ...); ``n_live`` as in
    ``sample_gather``."""
    if queries.dim() != 2:
        raise ValueError(f"sample_gather_batched expects queries (C, d), "
                         f"got {tuple(queries.shape)}")
    c = queries.shape[0]
    res, rows, w = _draw_batch(generator, index, x_aug, queries, params, m,
                               max_probes, multiprobe, draws, store,
                               p_floor, n_live)        # fields (C, m)
    flat = SampleResult(*(f.reshape((-1,) + f.shape[2:]) for f in res))
    batch = _assemble(flat, rows, w, example_offset, False, row_width)
    unflat = GatherBatch(*(f.reshape((c, m) + f.shape[1:]) for f in batch))
    if normalize:
        w = unflat.loss_weights
        w = w / torch.clamp(w.mean(dim=1, keepdim=True), min=1e-30)
        unflat = unflat._replace(loss_weights=w)
    return unflat
