"""The bucket-probe kernel's warp-wide k-ary search, modelled in numpy.

``csrc/bucket_probe.cu`` finds lo (the lower bound of a code c) and hi
(the lower bound of c + 1) in a sorted table with a whole warp: each
round the 32 lanes load pivots of the unknown run and one ballot per
bound counts the pivots below its key.  The kernel runs only on a card,
so this model repeats its index arithmetic line for line (``pivot``,
``narrow``, ``warp_bounds``) and holds it against ``np.searchsorted``
on rows with heavy duplicates and keys outside the row's range, and
holds its round count to the bound the source note states.  It imports
neither JAX nor the kernel library.
"""

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # container has no hypothesis wheel; use the shim
    from _hypothesis_compat import given, settings, st

LANES = 32                       # kLanes
TOP = 2 ** 32 - 1                # the largest code (K 32)


def pivot(a, m, k):
    """Lane k's pivot in the unknown run [a, a + m), m > 0."""
    return a + k if m <= LANES else a + (k + 1) * (m + 1) // (LANES + 1) - 1


def narrow(a, b, below):
    """[a, b) narrowed to the gap that holds the bound, given the number
    of the round's pivots below the key."""
    m = b - a
    if m == 0:
        return a, b
    pivots = min(m, LANES)
    a0 = a
    if below > 0:
        a = pivot(a0, m, below - 1) + 1
    if below < pivots:
        b = pivot(a0, m, below)
    return a, b


def ballot(row, a, m, key):
    """One bound's round: the lanes' positions, which lanes are on, and
    popc(ballot(on && row[pos] < key)); checks that the on lanes read
    distinct ascending positions inside [a, a + m) and that the lanes
    whose pivot is below the key are a prefix (what popc relies on)."""
    lanes = np.arange(LANES)
    on = lanes < m
    pos = np.array([pivot(a, m, k) for k in lanes])
    p_on = pos[on]
    assert p_on.size == 0 or (p_on[0] >= a and p_on[-1] < a + m)
    assert np.all(np.diff(p_on) > 0)
    if 0 < m <= LANES:                   # the last round: one window
        assert np.array_equal(p_on, a + np.arange(m))
    v = np.where(on, row[np.where(on, pos, 0)], 0)
    bits = on & (v < key)
    below = int(np.count_nonzero(bits))
    assert np.array_equal(bits, lanes < below)
    return below, p_on


def warp_bounds(row, c):
    """(lo, hi, rounds, loads) of the kernel's search for code c."""
    n = len(row)
    c1 = c + 1
    a0, b0, a1, b1 = 0, n, 0, n
    rounds = loads = 0
    while a0 < b0 or a1 < b1:
        m0, m1 = b0 - a0, b1 - a1
        below0, p0 = ballot(row, a0, m0, c)
        below1, p1 = ballot(row, a1, m1, c1)
        # one load a lane serves both ballots while the runs coincide
        loads += p0.size + (0 if (a0, b0) == (a1, b1) else p1.size)
        a0, b0 = narrow(a0, b0, below0)
        a1, b1 = narrow(a1, b1, below1)
        rounds += 1
    return a0, a1, rounds, loads


def rounds_bound(n):
    """Rounds that cover any key in n codes: while more than 32 codes are
    unknown, a round leaves at most ceil((m - 32) / 33); then one more."""
    r, m = 1, n
    while m > LANES:
        m = -(-(m - LANES) // (LANES + 1))
        r += 1
    return r


def _keys(row, rng):
    """Every distinct code, its neighbours, the ends and outside them."""
    vals = np.unique(row)
    picks = rng.choice(vals, size=min(vals.size, 12), replace=False)
    return sorted({0, 1, TOP, int(row[0]) - 1, int(row[-1]) + 1,
                   *map(int, picks), *(int(v) + 1 for v in picks),
                   *(int(v) - 1 for v in picks)} - {-1, TOP + 1})


def _check(row, keys):
    for c in keys:
        lo, hi, rounds, _ = warp_bounds(row, c)
        assert lo == np.searchsorted(row, c, side="left"), (len(row), c)
        assert hi == np.searchsorted(row, c, side="right"), (len(row), c)
        assert rounds <= rounds_bound(len(row)), (len(row), c, rounds)


@settings(deadline=None, max_examples=25)
@given(n=st.integers(1, 40_000), distinct=st.integers(1, 64),
       seed=st.integers(0, 2 ** 31 - 1))
def test_matches_searchsorted_on_duplicate_heavy_rows(n, distinct, seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 2 ** 32, size=distinct)
    row = np.sort(rng.choice(vals, size=n))
    _check(row, _keys(row, rng))


@settings(deadline=None, max_examples=10)
@given(n=st.integers(1, 40_000), seed=st.integers(0, 2 ** 31 - 1))
def test_keys_outside_the_rows_range(n, seed):
    rng = np.random.default_rng(seed)
    lo_v = int(rng.integers(1, 2 ** 31))
    row = np.sort(rng.integers(lo_v, lo_v + 2 ** 20, size=n))
    _check(row, [0, lo_v - 1, int(row[-1]) + 1, TOP])


# the round thresholds of the source note (32, 33 * 32 + 32 = 1,088,
# 33 * 1,088 + 32 = 35,936) and one code past each
@pytest.mark.parametrize("n", [1, 31, 32, 33, 1_088, 1_089, 1_090, 35_936,
                               35_937, 35_938])
def test_round_thresholds(n):
    rng = np.random.default_rng(n)
    row = np.sort(rng.integers(0, 2 ** 32, size=n))
    _check(row, [int(v) for v in row[:: max(1, n // 40)]] +
           [0, TOP, int(row[-1]) + 1])
    want = 1 if n <= 32 else 2 if n <= 1_088 else 3 if n <= 35_936 else 4
    assert rounds_bound(n) == want


@pytest.mark.parametrize("n,rounds", [(463_715, 4), (2_048, 3)])
def test_rounds_at_the_paths_sizes(n, rounds):
    """The LGD index (N 463,715) and the train path's (N 2,048): the
    kernel's 4 and 3 rounds against the binary search's 19 and 12."""
    assert rounds_bound(n) == rounds
    assert int(np.ceil(np.log2(n + 1))) == {463_715: 19, 2_048: 12}[n]
    rng = np.random.default_rng(1)
    row = np.sort(rng.integers(0, 32, size=n))          # K 5: 32 buckets
    seen = 0
    for c in range(33):
        lo, hi, r, loads = warp_bounds(row, c)
        assert (lo, hi) == (np.searchsorted(row, c, side="left"),
                            np.searchsorted(row, c, side="right"))
        assert r <= rounds and loads <= 2 * LANES * r
        seen = max(seen, r)
    assert seen == rounds


@pytest.mark.parametrize("case", ["all_equal", "straddle", "top"])
def test_edge_rows(case):
    """A table of one code; duplicates across every pivot of the first
    round; the code 2^32 - 1 (K 32), whose c + 1 leaves 32 bits."""
    n = 35_938
    if case == "all_equal":
        row = np.full(n, 5, dtype=np.int64)
        keys, whole = [0, 4, 5, 6, TOP], 5
    elif case == "straddle":
        row = np.repeat(np.arange(0, 68, 2, dtype=np.int64), n // 34 + 1)[:n]
        keys, whole = list(range(70)), None
    else:
        row = np.sort(np.concatenate([
            np.full(n // 3, TOP), np.random.default_rng(2).integers(
                0, 2 ** 32 - 1, size=n - n // 3)]))
        keys, whole = [0, TOP - 1, TOP, int(row[0])], TOP
    _check(row, keys)
    if whole is not None:
        lo, hi, _, _ = warp_bounds(row, whole)
        assert (lo, hi) == (n - np.count_nonzero(row == whole)
                            if whole == TOP else 0, n)
