"""The draw_assemble kernel's arithmetic, modelled in numpy.

``csrc/gather_weight.cu``'s ``draw_assemble_kernel`` runs Algorithm 1
after the probe (the candidate walk, the slot, the id, the collision
probability, p) and the row gather with its weight, one block per
(query, repetition).  It runs only on a card, so this file repeats its
arithmetic line for line in numpy (``walk``, ``slot_of``, ``block_sums``,
``law_cp``, ``prob``, ``weight``) and holds the model against the
sampler's plain version (``_sample_rows`` and ``gather_weight_ref``):

  * the walk, the slot and the id bitwise, on random bounds and draws
    and on the edge cases (every candidate empty, the winner in the last
    32-wide round, the winner at probe 2 of J 3, a size-1 bucket,
    slot_u = 1 - 2^-24, duplicate ids, p below p_floor);
  * the probability and the weight within rtol 1e-4, the limit the chip
    check holds the kernel to (the plain version sums in torch's order
    and calls torch's acos and pow);
  * the fixed float32 sum order against torch.sum and a float64 sum, the
    same bits on every call;
  * the streaming fallback (``n_live``): the draw a slot of table 0's
    live prefix, the id ``order[0, slot]``, p = 1/n_live and the weights
    1/(p n_live), on walks that mostly miss;
  * the band mode of a banded family (``starts``): the band drawn as
    floor(band_u · total) against the starts, the walk in that band's
    plane, p = (n_band/total) · q_r · miss^(l-1) / size, the fallback
    ``order[0, floor(fallback_u · total)]`` with p = 1/total; and the law
    on the first ``d_law`` coordinates only (the band id is not geometry).

It also checks that every ported family maps to a collision law the
kernel knows, and that the model's constants are the source's.
"""

import dataclasses
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import LSHParams, probe_masks
from repro_torch.core.families import FAMILIES, LSHFamily, get_family
from repro_torch.core.sampler import (
    SampleDraws, _uniform_below, draw_assemble,
    draw_assemble_plain)
from repro_torch.kernels.gather_weight import (
    LAWS, draw_assemble_cuda, law_code)

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "csrc" / "gather_weight.cu").read_text()
THREADS = 128                    # kDrawThreads
WARPS = THREADS // 32
LANES = 32
F32 = np.float32
PI = F32(math.pi)                # kPi
RTOL = 1e-4                      # p and w against the plain version


# -- the model ---------------------------------------------------------------

def walk(ts, lo, hi, j):
    """Warp 0's walk for one block: ts (P,) its table draws, lo/hi (J, L)
    its query's bounds.  Returns (first candidate or -1, t, lo, size) of
    the winning lane and the rounds taken."""
    cands = len(ts) * j
    lanes = np.arange(LANES)
    rounds = 0
    for base in range(0, cands, LANES):
        rounds += 1
        c = base + lanes
        on = c < cands
        t = np.where(on, ts[np.where(on, c // j, 0)], 0)
        pj = c % j
        lov = np.where(on, lo[pj, t], 0)
        size = np.where(on, hi[pj, t] - lov, 0)
        hit = size > 0                                   # __ballot_sync
        if hit.any():
            win = int(np.argmax(hit))                    # __ffs(hit) - 1
            return base + win, int(t[win]), int(lov[win]), int(size[win]), \
                rounds
    return -1, 0, 0, 0, rounds


def slot_of(u, size):
    """min(floor(u * (f32)size), size - 1): one rounded f32 product."""
    return min(int(np.floor(F32(u) * F32(size))), size - 1)


def block_sums(x, q):
    """x.q, x.x, q.q in the kernel's order: thread tid sums features tid,
    tid + 128, ... (a rounded product, then a rounded add), a
    shuffle-down tree per warp, then the warps in order."""
    d = len(x)
    x, q = x.astype(F32), q.astype(F32)
    acc = np.zeros((3, THREADS), F32)
    tid = np.arange(THREADS)
    for base in range(0, d, THREADS):
        c = base + tid
        on = c < d
        xv, qv = x[np.where(on, c, 0)], q[np.where(on, c, 0)]
        for row, prod in enumerate((xv * qv, xv * xv, qv * qv)):
            acc[row] = np.where(on, acc[row] + prod, acc[row])
    v = acc.reshape(3, WARPS, LANES)
    for off in (16, 8, 4, 2, 1):
        v = v[:, :, :off] + v[:, :, off:2 * off]
    total = v[:, 0, 0]
    for w in range(1, WARPS):
        total = total + v[:, w, 0]
    return tuple(F32(s) for s in total)


def law_cp(law, xq, xx, qq):
    """cp by the family's law; the comparisons keep NaN as torch.clamp."""
    if law == "angle":
        den = F32(np.sqrt(xx) * np.sqrt(qq))
        cs = xq / (F32(1e-30) if den < F32(1e-30) else den)
    else:
        den = F32(xx * qq)
        cs = F32(xq * xq) / (F32(1e-30) if den < F32(1e-30) else den)
    cs = F32(-1.0) if cs < -1 else (F32(1.0) if cs > 1 else cs)
    return F32(F32(1.0) - F32(np.arccos(cs)) / PI)


def prob(cp, first, size, j, k, popc, p_fallback, p_band=None):
    """p of one repetition from its cp and its walk; ``p_band`` (band
    mode) n_band/total, which takes the multi-probe form at every J."""
    if first < 0:
        return F32(p_fallback)
    pj, l = first % j, first // j + 1
    lm1, fsize, fk = F32(l - 1), F32(size), F32(k)
    if j == 1 and p_band is None:
        cpk = F32(np.power(cp, fk))
        return F32(cpk * F32(np.power(F32(1) - cpk, lm1))) / fsize
    total, q_win = F32(0), F32(0)
    for jj in range(j):
        r = F32(popc[jj])
        q_r = F32(np.power(cp, fk - r)) * F32(np.power(F32(1) - cp, r))
        total = F32(total + q_r)
        if jj == pj:
            q_win = q_r
    miss = F32(1) - total
    miss = F32(0) if miss < 0 else miss
    if p_band is not None:
        q_win = F32(p_band * q_win)
    return F32(q_win * F32(np.power(miss, lm1))) / fsize


def weight(p, p_floor, n):
    pf = F32(p_floor) if p < F32(p_floor) else p
    return F32(1) / F32(pf * F32(n))


def band_of(u, starts):
    """The band mode's draw: the slot min(floor(u·total), total-1), then
    the count of starts[1..nb] <= slot (the kernel's binary search)."""
    total = int(starts[-1])
    slot = slot_of(u, total)
    lo_b, hi_b = 0, len(starts) - 1
    while lo_b < hi_b:
        mid = (lo_b + hi_b) >> 1
        if starts[mid + 1] <= slot:
            lo_b = mid + 1
        else:
            hi_b = mid
    return lo_b


def model(draws, lo, hi, order, x, queries, law, k, masks, store=None,
          p_floor=1e-8, n_live=None, starts=None, d_law=None):
    """Every block of one draw_assemble launch: the result fields (B, m),
    and with a store the rows (B·m, W) and weights (B·m,).  With
    ``n_live`` the fallback draw is a slot of order[0, :n_live] and the
    fallback p and the weights' N are n_live's.  With ``starts`` (band
    mode) ``lo``/``hi`` are (B, nb, J, L) and each block draws its band
    first.  The law reads the first ``d_law`` coordinates."""
    tables, slot_u = (np.asarray(a) for a in draws[:2])
    fb = None if draws.fallback is None else np.asarray(draws.fallback)
    b, m, p = tables.shape
    j = len(masks)
    n = order.shape[1]
    popc = [bin(mk).count("1") for mk in masks]
    out = {key: np.zeros((b, m), dt) for key, dt in (
        ("indices", np.int64), ("probs", F32), ("n_probes", np.int32),
        ("bucket_sizes", np.int32), ("fallback", bool),
        ("probe_code", np.int32))}
    rows, w = [], []
    d_law = x.shape[1] if d_law is None else d_law
    for bi in range(b):
        for r in range(m):
            lo_q, hi_q, p_band = lo[bi], hi[bi], None
            if starts is not None:
                band = band_of(np.asarray(draws.band_u)[bi, r], starts)
                total = int(starts[-1])
                lo_q, hi_q = lo[bi, band], hi[bi, band]
                p_band = F32(F32(starts[band + 1] - starts[band])
                             / F32(total))
            first, t, lov, size, _ = walk(tables[bi, r], lo_q, hi_q, j)
            if first >= 0:
                idx = int(order[t, lov + slot_of(slot_u[bi, r], size)])
            elif starts is not None:
                idx = int(order[0, slot_of(
                    np.asarray(draws.fallback_u)[bi, r], total)])
            elif n_live is not None:
                assert 0 <= fb[bi, r] < n_live
                idx = int(order[0, fb[bi, r]])
            else:
                idx = int(fb[bi, r])
            assert 0 <= idx < n
            cp = law_cp(law, *block_sums(x[idx, :d_law],
                                         queries[bi, :d_law]))
            p_fb = (F32(1) / F32(total) if starts is not None else
                    F32(1.0 / (n if n_live is None else n_live)))
            pr = prob(cp, first, size, j, k, popc, p_fb, p_band)
            found = first >= 0
            vals = dict(indices=idx, probs=pr,
                        n_probes=first // j + 1 if found else p,
                        bucket_sizes=size, fallback=not found,
                        probe_code=first % j if found else -1)
            for key, val in vals.items():
                out[key][bi, r] = val
            if store is not None:
                rows.append(store[idx])
                w.append(weight(pr, p_floor, n if n_live is None else n_live))
    if store is None:
        return out, None, None
    return out, np.stack(rows), np.array(w, F32)


# -- inputs ------------------------------------------------------------------

def _bounds(rng, b, j, l, n, empty):
    """Random (B, J, L) bounds inside [0, N], a share ``empty`` of them
    empty."""
    size = rng.integers(1, 40, (b, j, l))
    size[rng.random((b, j, l)) < empty] = 0
    lo = rng.integers(0, n - size + 1)
    return lo.astype(np.int32), (lo + size).astype(np.int32)


def _case(seed, b=2, m=5, j=1, p=20, l=12, n=300, d=11, empty=0.6):
    rng = np.random.default_rng(seed)
    lo, hi = _bounds(rng, b, j, l, n, empty)
    order = np.stack([rng.permutation(n) for _ in range(l)]).astype(np.int64)
    x = rng.standard_normal((n, d)).astype(F32)
    q = rng.standard_normal((b, d)).astype(F32)
    draws = SampleDraws(
        torch.from_numpy(rng.integers(0, l, (b, m, p))),
        torch.from_numpy(rng.random((b, m)).astype(F32)),
        torch.from_numpy(rng.integers(0, n, (b, m))))
    store = rng.integers(0, 50_000, (n, 9)).astype(np.int32)
    return dict(draws=draws, lo=lo, hi=hi, order=order, x=x, q=q,
                store=store)


def _masks(k, j):
    return probe_masks(k, j) if j > 1 else (0,)


def _plain(c, family, k, masks, p_floor=1e-8, n_live=None):
    """The sampler's plain composition on the case (CPU tensors)."""
    params = LSHParams(k=k, l=c["lo"].shape[2], dim=c["x"].shape[1],
                       family=family)
    t = torch.from_numpy
    return draw_assemble_plain(
        c["draws"], t(c["lo"]), t(c["hi"]), t(c["order"]), t(c["x"]),
        t(c["q"]), params, c["draws"].tables.shape[2], masks,
        t(c["store"]), p_floor, n_live)


def _hold(c, family, k, j, p_floor=1e-8, n_live=None):
    """The model against the plain composition: integer fields and rows
    bitwise, p and w within RTOL.  Returns the model's fields."""
    masks = _masks(k, j)
    want, rows_w, w_w = _plain(c, family, k, masks, p_floor, n_live)
    got, rows, w = model(c["draws"], c["lo"], c["hi"], c["order"], c["x"],
                         c["q"], get_family(family).cp_law, k, masks,
                         c["store"], p_floor, n_live)
    for key in ("indices", "n_probes", "bucket_sizes", "fallback",
                "probe_code"):
        np.testing.assert_array_equal(got[key], getattr(want, key).numpy(),
                                      err_msg=key)
    np.testing.assert_array_equal(rows, rows_w.numpy())
    np.testing.assert_allclose(got["probs"], want.probs.numpy(), rtol=RTOL)
    np.testing.assert_allclose(w, w_w.numpy(), rtol=RTOL)
    return got, w


# -- the walk, the slot and the id --------------------------------------------

@pytest.mark.parametrize("j", [1, 3])
@pytest.mark.parametrize("p,empty", [(1, 0.5), (31, 0.9), (32, 0.95),
                                     (33, 0.97), (200, 0.99), (20, 0.0)])
@pytest.mark.parametrize("seed", [0, 1])
def test_walk_matches_the_plain_version(seed, p, empty, j):
    c = _case(100 * seed + p, p=p, j=j, empty=empty)
    _hold(c, "dense", 5, j)


def _edit(c, **kw):
    c = dict(c)
    c.update(kw)
    return c


def _edge(name):
    """(case, J, what to check of the model's fields)."""
    c = _case(7, b=1, m=4, p=40, empty=0.5)
    lo, hi = c["lo"].copy(), c["hi"].copy()
    tables = c["draws"].tables.clone()
    if name == "all_empty":
        hi[:] = lo
        return _edit(c, hi=hi), 1, lambda f: (
            f["fallback"].all() and (f["probe_code"] == -1).all()
            and (f["n_probes"] == 40).all() and (f["bucket_sizes"] == 0).all()
            and np.array_equal(f["indices"], c["draws"].fallback.numpy()))
    if name == "last_round":
        # P 70, J 1: 3 rounds of 32, the only non-empty table drawn last
        tables = torch.zeros((1, 4, 70), dtype=torch.int64)
        tables[:, :, -1] = 1
        hi[0, 0, 0] = lo[0, 0, 0]
        lo[0, 0, 1], hi[0, 0, 1] = 0, 5
        c["draws"] = c["draws"]._replace(tables=tables)
        return _edit(c, lo=lo, hi=hi), 1, lambda f: (
            f["n_probes"] == 70).all()
    if name == "probe_2":
        # J 3: probes 0 and 1 of every table empty, probe 2 of table 3 not
        c = _case(8, b=1, m=4, j=3, p=40, empty=1.0)
        lo, hi = c["lo"].copy(), c["hi"].copy()
        lo[0, 2, 3], hi[0, 2, 3] = 0, 4
        tables = c["draws"].tables.clone()
        tables[:, :, 5] = 3
        c["draws"] = c["draws"]._replace(tables=tables)
        return _edit(c, lo=lo, hi=hi), 3, lambda f: (
            (f["probe_code"] == 2).all() and (f["n_probes"] <= 6).all())
    if name == "size_1":
        hi = np.where(hi > lo, lo + 1, lo).astype(np.int32)
        return _edit(c, hi=hi), 1, lambda f: (
            f["bucket_sizes"][~f["fallback"]] == 1).all()
    if name == "u_top":
        u = torch.full((1, 4), 1 - 2 ** -24)
        c["draws"] = c["draws"]._replace(slot_u=u)
        hi = np.where(hi > lo, lo + np.array([1, 3, 7, 40])[
            np.arange(hi.size).reshape(hi.shape) % 4], lo).astype(np.int32)
        hi = np.minimum(hi, 300).astype(np.int32)
        return _edit(c, hi=hi), 1, lambda f: True
    if name == "duplicates":
        tables[:] = tables[:, :1]
        u = c["draws"].slot_u.clone()
        u[:] = u[:, :1]
        fb = c["draws"].fallback.clone()
        fb[:] = fb[:, :1]
        c["draws"] = SampleDraws(tables, u, fb)
        return c, 1, lambda f: (f["indices"] == f["indices"][0, 0]).all()
    raise KeyError(name)


@pytest.mark.parametrize("name", ["all_empty", "last_round", "probe_2",
                                  "size_1", "u_top", "duplicates"])
def test_walk_edge_cases(name):
    c, j, check = _edge(name)
    got, _ = _hold(c, "dense", 5, j)
    assert check(got)


@pytest.mark.parametrize("size", [1, 2, 3, 7, 1000, 2 ** 24 - 1, 2 ** 24,
                                  2 ** 25 + 3, 2 ** 31 - 1])
@pytest.mark.parametrize("u", [0.0, 0.5, 1 - 2 ** -24, 0.99999994])
def test_slot_arithmetic(u, size):
    """slot_of is the plain version's _uniform_below, bitwise, up to the
    largest int32 size."""
    want = _uniform_below(torch.tensor([u], dtype=torch.float32),
                          torch.tensor([size], dtype=torch.int32))
    assert slot_of(F32(u), size) == int(want[0])
    assert 0 <= slot_of(F32(u), size) < size


def test_walk_rounds():
    """At most ceil(P·J/32) rounds: 7 at P 200, J 1; 19 at J 3."""
    rng = np.random.default_rng(3)
    for j, most in ((1, 7), (3, 19)):
        lo = np.zeros((j, 10), np.int32)
        ts = rng.integers(0, 10, 200)
        assert walk(ts, lo, lo, j)[4] == most


def _live(c, n_live, empty=0.97):
    """The case on a streaming index: the bounds inside the live prefix
    [0, n_live), most buckets empty, the fallback draws in [0, n_live)."""
    rng = np.random.default_rng(n_live)
    b, j, l = c["lo"].shape
    size = rng.integers(1, 6, (b, j, l))
    size[rng.random((b, j, l)) < empty] = 0
    size = np.minimum(size, n_live)
    lo = rng.integers(0, n_live - size + 1)
    fb = torch.from_numpy(rng.integers(0, n_live, c["draws"].slot_u.shape))
    c = _edit(c, lo=lo.astype(np.int32), hi=(lo + size).astype(np.int32))
    c["draws"] = c["draws"]._replace(fallback=fb)
    return c


@pytest.mark.parametrize("j", [1, 3])
@pytest.mark.parametrize("n_live", [1, 37, 300])
def test_live_prefix_fallback(n_live, j):
    """The streaming fallback: order[0, draw] over the live prefix, p =
    1/n_live and weights 1/(p n_live), against the plain composition."""
    c = _live(_case(60 + n_live, b=3, m=6, j=j, p=30), n_live)
    got, w = _hold(c, "dense", 5, j, n_live=n_live)
    fb = got["fallback"]
    assert fb.any() and (~fb).any() or n_live == 1
    live_ids = set(c["order"][0, :n_live].tolist())
    assert set(got["indices"][fb].tolist()) <= live_ids
    np.testing.assert_array_equal(got["probs"][fb], F32(1.0 / n_live))
    _, _, w_plain = _plain(c, "dense", 5, _masks(5, j), n_live=n_live)
    np.testing.assert_array_equal(
        w_plain.numpy().reshape(fb.shape)[fb],
        F32(1) / F32(F32(1.0 / n_live) * F32(n_live)))


def test_live_count_is_a_host_int():
    c = _case(13)
    with pytest.raises(TypeError, match="Python int"):
        _plain(c, "dense", 5, (0,), n_live=torch.tensor(100))


# -- the probability and the weight --------------------------------------------

@pytest.mark.parametrize("family", ["quadratic", "srp", "mips"])
@pytest.mark.parametrize("j", [1, 3])
def test_probability_and_weight(family, j):
    c = _case(40 + j, b=3, m=6, j=j, p=30, d=13, empty=0.8)
    if family == "mips":                      # augmented: unit-norm rows
        c["x"] = (c["x"] / np.linalg.norm(c["x"], axis=1).max()).astype(F32)
    _hold(c, family, 5, j)


def test_p_below_the_floor():
    """A probability below p_floor gets the floor's weight, bitwise."""
    c = _case(9, b=1, m=8, p=12, empty=0.3)
    got, w = _hold(c, "dense", 5, 1, p_floor=0.5)
    _, _, w_plain = _plain(c, "dense", 5, (0,), p_floor=0.5)
    below = (got["probs"] < F32(0.5)).reshape(-1)
    assert below.any()
    floor_w = F32(1) / F32(F32(0.5) * F32(300))
    np.testing.assert_array_equal(w[below], floor_w)
    np.testing.assert_array_equal(w_plain.numpy()[below], floor_w)


# -- the sum order ------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 5, 91, 128, 129, 1000, 3072])
def test_sum_order(d):
    """The fixed order's sums are within the float32 error bound of the
    exact sums (Higham's gamma_(d+1) times the sum of magnitudes), as
    torch.sum's are, and two evaluations give the same bits."""
    rng = np.random.default_rng(d)
    x = rng.standard_normal(d).astype(F32)
    q = (rng.standard_normal(d) + 0.5).astype(F32)
    got = block_sums(x, q)
    assert [s.tobytes() for s in got] == [s.tobytes()
                                          for s in block_sums(x, q)]
    gamma = (d + 1) * 2.0 ** -24 / (1 - (d + 1) * 2.0 ** -24)
    tx, tq = torch.from_numpy(x), torch.from_numpy(q)
    for s, (a, c) in zip(got, ((x, q), (x, x), (q, q))):
        exact = np.dot(a.astype(np.float64), c.astype(np.float64))
        mag = np.abs(a.astype(np.float64) * c).sum()
        assert abs(float(s) - exact) <= gamma * mag
    want = [torch.sum(tx * tq), torch.sum(tx * tx), torch.sum(tq * tq)]
    for s, w in zip(got, want):
        assert abs(float(s) - float(w)) <= 2 * gamma * float(
            torch.sum((tx.abs() + tq.abs()) ** 2))


# -- the band mode ------------------------------------------------------------

NB = 8


def _band_case(seed, b=2, m=6, j=1, p=20, l=12, n=300, d=11, empty=0.6,
               empty_band=3):
    """A banded draw: a random partition of the n sorted slots into NB
    bands (band ``empty_band`` empty), (B, NB, J, L) bounds inside each
    band's region, rows whose last coordinate is their band id, and the
    band and fallback uniforms."""
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(np.arange(1, n), NB - 2, replace=False))
    counts = np.diff(np.concatenate([[0], cuts, [n]]))
    counts = np.insert(counts, empty_band, 0)            # NB bands
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    lo = np.zeros((b, NB, j, l), np.int32)
    hi = np.zeros((b, NB, j, l), np.int32)
    for band in range(NB):
        a_, z_ = starts[band], starts[band + 1]
        size = np.minimum(rng.integers(1, 30, (b, j, l)), z_ - a_)
        size[rng.random((b, j, l)) < empty] = 0
        start = a_ + rng.integers(0, z_ - a_ - size + 1)
        lo[:, band], hi[:, band] = start, start + size
    order = np.stack([rng.permutation(n) for _ in range(l)]).astype(np.int64)
    band_of_row = np.searchsorted(starts[1:], np.argsort(order[0]),
                                  side="right")
    x = rng.standard_normal((n, d)).astype(F32)
    x[:, -1] = band_of_row                       # the band coordinate
    q = rng.standard_normal((b, d)).astype(F32)
    q[:, -1] = 0.0
    draws = SampleDraws(
        torch.from_numpy(rng.integers(0, l, (b, m, p))),
        torch.from_numpy(rng.random((b, m)).astype(F32)), None,
        band_u=torch.from_numpy(rng.random((b, m)).astype(F32)),
        fallback_u=torch.from_numpy(rng.random((b, m)).astype(F32)))
    store = rng.integers(0, 50_000, (n, 9)).astype(np.int32)
    return dict(draws=draws, lo=lo, hi=hi, order=order, x=x, q=q,
                store=store, starts=starts)


def _hold_band(c, k, j, p_floor=1e-8, n_live=None):
    """The model's band mode against the plain composition with
    ``starts``, for the banded family; integer fields and rows bitwise,
    p and w within RTOL."""
    fam = get_family("mips_banded")
    masks = _masks(k, j)
    params = LSHParams(k=k, l=c["lo"].shape[3], dim=c["x"].shape[1],
                       family="mips_banded")
    t = torch.from_numpy
    want, rows_w, w_w = draw_assemble_plain(
        c["draws"], t(c["lo"]), t(c["hi"]), t(c["order"]), t(c["x"]),
        t(c["q"]), params, c["draws"].tables.shape[2], masks,
        t(c["store"]), p_floor, n_live, t(c["starts"]))
    got, rows, w = model(c["draws"], c["lo"], c["hi"], c["order"], c["x"],
                         c["q"], fam.cp_law, k, masks, c["store"], p_floor,
                         n_live, starts=c["starts"],
                         d_law=fam.law_dim(c["x"].shape[1]))
    for key in ("indices", "n_probes", "bucket_sizes", "fallback",
                "probe_code"):
        np.testing.assert_array_equal(got[key], getattr(want, key).numpy(),
                                      err_msg=key)
    np.testing.assert_array_equal(rows, rows_w.numpy())
    np.testing.assert_allclose(got["probs"], want.probs.numpy(), rtol=RTOL)
    np.testing.assert_allclose(w, w_w.numpy(), rtol=RTOL)
    return got, w


@pytest.mark.parametrize("j", [1, 3])
@pytest.mark.parametrize("p,empty", [(20, 0.6), (40, 0.97), (200, 0.99)])
@pytest.mark.parametrize("seed", [0, 1])
def test_band_draw_matches_the_plain_version(seed, p, empty, j):
    """The band, the walk in its plane, the slot, the id and p = (n_band /
    total) · q_r · miss^(l-1) / size; never a row of the empty band."""
    c = _band_case(10 * seed + p, j=j, p=p, empty=empty)
    got, _ = _hold_band(c, 5, j)
    s = c["starts"]
    empty_ids = set(c["order"][0, s[3]:s[4]].tolist())
    assert not empty_ids & set(got["indices"].reshape(-1).tolist())


@pytest.mark.parametrize("u", [0.0, 0.37, 1 - 2 ** -24])
def test_band_of_the_draw(u):
    """band_of is the plain version's searchsorted(starts[1:], slot,
    right=True) of its _uniform_below slot; an empty band is never
    drawn, and u -> 1 draws the last band."""
    starts = np.array([0, 5, 5, 9, 20, 20, 21, 40, 40], np.int32)
    total = torch.tensor(int(starts[-1]))
    slot = _uniform_below(torch.tensor([u], dtype=torch.float32), total)
    want = torch.searchsorted(torch.from_numpy(starts[1:]).long(), slot,
                              right=True)
    band = band_of(F32(u), starts)
    assert band == int(want[0])
    assert starts[band + 1] > starts[band]
    if u > 0.9:
        assert band == 6


def test_band_fallback():
    """Every bucket of every band empty: the fallback is order[0,
    floor(fallback_u · total)] with p = 1/total, and the weights are
    1/(p · N) with N the store height (no n_live), or n_live."""
    c = _band_case(5, m=8, empty=1.0)
    total = int(c["starts"][-1])
    for n_live in (None, 300):
        got, w = _hold_band(c, 5, 1, n_live=n_live)
        assert got["fallback"].all() and (got["probe_code"] == -1).all()
        slots = [slot_of(u, total) for u in
                 c["draws"].fallback_u.numpy().reshape(-1)]
        np.testing.assert_array_equal(got["indices"].reshape(-1),
                                      c["order"][0, slots])
        np.testing.assert_array_equal(got["probs"], F32(1) / F32(total))


def test_band_mode_reads_only_d_law():
    """The law reads d_law = d - 1 coordinates: with the band id (up to 7)
    in |x| the collision probabilities, and so p, would differ."""
    c = _band_case(6, j=3, empty=0.3)
    got, _ = _hold_band(c, 5, 3)
    wrong, _, _ = model(c["draws"], c["lo"], c["hi"], c["order"], c["x"],
                        c["q"], "angle", 5, _masks(5, 3), c["store"],
                        starts=c["starts"])
    found = ~got["fallback"]
    assert found.any()
    np.testing.assert_array_equal(wrong["indices"], got["indices"])
    assert not np.allclose(wrong["probs"][found], got["probs"][found],
                           rtol=RTOL)


def test_band_mode_needs_the_uniforms():
    c = _band_case(7)
    c["draws"] = c["draws"]._replace(band_u=None)
    with pytest.raises(ValueError, match="band_u and fallback_u"):
        _hold_band(c, 5, 1)


def test_flat_mode_needs_the_fallback_ids():
    """A banded draw carries no fallback id: the flat walk refuses it."""
    c = _case(7)
    c["draws"] = c["draws"]._replace(fallback=None)
    with pytest.raises(ValueError, match="needs fallback ids"):
        _hold(c, "srp", 5, 1)


# -- laws, constants and dispatch ---------------------------------------------

@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_every_family_has_a_law(name):
    fam = get_family(name)
    want = "quadratic" if fam.proj_kind == "quadratic" else "angle"
    assert fam.cp_law == want
    assert LAWS[law_code(fam)] == want


def test_unknown_law_raises():
    @dataclasses.dataclass(frozen=True)
    class Minhash(LSHFamily):
        name: str = "minhash"

    with pytest.raises(ValueError, match="knows no collision law"):
        law_code(Minhash())
    with pytest.raises(ValueError, match="knows no collision law"):
        law_code(dataclasses.replace(get_family("srp"), cp_law="banded"))


def test_model_constants_are_the_sources():
    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             SOURCE).group(1))

    assert const("kDrawThreads") == THREADS
    enum = re.search(r"enum Law : int \{([^}]*)\}", SOURCE).group(1)
    assert [e.split("=")[0].strip() for e in enum.split(",")] == [
        "k" + law.capitalize() for law in LAWS]


@pytest.mark.parametrize("store", [False, True])
def test_cpu_dispatch_is_the_plain_version(store):
    c = _case(11, j=3, empty=0.7)
    params = LSHParams(k=5, l=12, dim=11, family="quadratic")
    t = torch.from_numpy
    args = (c["draws"], t(c["lo"]), t(c["hi"]), t(c["order"]), t(c["x"]),
            t(c["q"]), params, 20, probe_masks(5, 3),
            t(c["store"]) if store else None)
    got, want = draw_assemble(*args), draw_assemble_plain(*args)
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    for a, b in zip(got[1:], want[1:]):
        assert (a is None and b is None) or torch.equal(a, b)


def test_the_wrapper_takes_only_card_tensors():
    c = _case(12)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="CUDA tensor"):
        draw_assemble_cuda(t(c["lo"]), t(c["hi"]),
                           t(c["order"]), t(c["x"]), t(c["q"]),
                           c["draws"].tables, c["draws"].slot_u,
                           c["draws"].fallback, (0,), k=5, law=0,
                           p_fallback=1 / 300)
