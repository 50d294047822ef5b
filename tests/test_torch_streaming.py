"""The port's streaming index against the JAX package, on the CPU.

* Index mutations (``delta`` / ``append`` / ``evict`` / ``grow_index``)
  on the same codes, with padded duplicate ids: ``sorted_codes`` and
  ``order`` bitwise after every op; an all-rows delta bitwise a full
  warm refresh.
* ``n_live`` draws on a streaming index with most slots evicted (so
  most walks fall back to the live prefix), with the reference's draws
  (``jax_sample_draws(n_live=)``): ids and walk results bitwise, p and
  weights at the golden-pin tolerance (rtol 1e-5, atol 1e-7).
* The streaming pipeline against ``repro.data.LSHSampledPipeline`` on
  the same projections: features of an integer embedding (exact in
  both), codes equal (no projection within 1e-4 of zero at these
  seeds), then membership, store, ``sorted_codes`` and ``order``
  bitwise after appends, a window auto-evict and an explicit evict,
  and batches drawn with the reference's draws (tokens and ids bitwise,
  weights rtol 1e-5).
* One streaming run's cumulative fallback share (``sampler_stats``):
  draws, ``fallback_rate``, ``primary_miss_rate`` and the last batch's
  share equal the reference's exactly (the same projections and draws,
  K 8 over ~100 live rows, so most exact buckets are empty), with the
  port's ``index_stats`` (distinct buckets a table, the query-feature
  cosine) computed on the reference's index too.
* The reference's streaming contracts, each after the test it names in
  tests/test_streaming.py: append equals a fresh build's membership,
  evict-all-then-append, capacity growth and compaction, the weighted
  mean over a moving window (statistical, a 3-sigma band), restore
  replays, and the mutation entry point.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.data as JD
import repro_torch.core as T
from _stats import mean_band
from _torch_parity import (ATOL, RTOL, assert_codes_match,
                           assert_results_match, jax_sample_draws, n, t)
from repro_torch import convert
from repro_torch.convert import codes_to_numpy
from repro_torch.core.tables import _merge_impl
from repro_torch.data import LSHPipelineConfig, LSHSampledPipeline

VOCAB, DIM, SEQ = 50, 16, 9
# integer embeddings: the features (sums, norms) are exact in both packages
EMBED = np.random.default_rng(1).integers(-4, 5, (VOCAB, DIM)).astype(
    np.float32)
QUERY = np.random.default_rng(2).standard_normal(DIM).astype(np.float32)
JPARAMS = {"embed": jnp.asarray(EMBED), "q": jnp.asarray(QUERY)}
TPARAMS = {"embed": torch.from_numpy(EMBED.copy()),
           "q": torch.from_numpy(QUERY.copy())}
SALT_STEP = 0x057E9


def j_feature_fn(params, chunk):
    return jnp.sum(params["embed"][chunk], axis=1)


def t_feature_fn(params, chunk):
    return params["embed"][chunk].sum(1)


def _tokens(n_rows=96, seed=2):
    return np.random.default_rng(seed).integers(
        0, VOCAB, (n_rows, SEQ)).astype(np.int32)


def _cfg(make, **kw):
    kw.setdefault("streaming", True)
    for k, v in dict(k=4, l=8, minibatch=8, refresh_every=0).items():
        kw.setdefault(k, v)
    return make(**kw)


def _pipe(tokens=None, seed=7, projections=None, **kw):
    return LSHSampledPipeline(
        seed, _tokens() if tokens is None else tokens, t_feature_fn,
        lambda p: p["q"], _cfg(LSHPipelineConfig, **kw),
        params=TPARAMS, device="cpu", projections=projections)


def _ref_pipe(tokens, seed=7, **kw):
    return JD.LSHSampledPipeline(
        jax.random.PRNGKey(seed), tokens, j_feature_fn, lambda p: p["q"],
        _cfg(JD.LSHPipelineConfig, use_pallas=False, **kw), params=JPARAMS)


def _live_sets(index, n_live):
    """Per-table {code: frozenset(slot ids)} over the live prefix."""
    sc, od = np.asarray(n(index.sorted_codes)), np.asarray(n(index.order))
    out = []
    for row in range(sc.shape[0]):
        lsc, lod = sc[row, :n_live], od[row, :n_live]
        out.append({int(c): frozenset(lod[lsc == c].tolist())
                    for c in np.unique(lsc)})
    return out


def _assert_live_prefix(pipe):
    """Every table: live codes first, the sentinel tail after, and the
    live prefix a permutation of the live slots."""
    sc, od = n(pipe.index.sorted_codes), n(pipe.index.order)
    live = set(np.flatnonzero(pipe._live_np).tolist())
    assert len(live) == pipe.n_live
    for row in range(sc.shape[0]):
        dead = sc[row] == T.EMPTY_CODE
        assert not dead[:pipe.n_live].any() and dead[pipe.n_live:].all()
        assert set(od[row, :pipe.n_live].tolist()) == live


def _assert_index_equal(got, want):
    np.testing.assert_array_equal(codes_to_numpy(got.sorted_codes),
                                  np.asarray(want.sorted_codes))
    np.testing.assert_array_equal(n(got.order), np.asarray(want.order))


# -- index mutations, bitwise on the same codes -------------------------------

def _both(codes: np.ndarray):
    """The same index in both packages from (L, C) uint32 codes."""
    order = np.argsort(codes, axis=1, kind="stable").astype(np.int32)
    sc = np.take_along_axis(codes, order, axis=1)
    proj = np.zeros((4, codes.shape[0] * 3), np.float32)
    return (J.LSHIndex(jnp.asarray(proj), jnp.asarray(sc),
                       jnp.asarray(order)),
            convert.index_from_numpy(proj, sc, order))


def _padded(rng, ids, codes):
    """Pad (ids, codes) by repeating the first entry, as the pipeline."""
    pad = int(rng.integers(1, 9))
    return (np.concatenate([ids, np.full(pad, ids[0])]).astype(np.int32),
            np.concatenate([codes, np.repeat(codes[:, :1], pad, 1)], 1))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mutation_chain_bitwise(seed):
    """build -> append -> delta -> evict -> grow -> append: both packages'
    merges on the same codes (K = 3, so ties everywhere) agree bitwise
    after every op; the live prefix holds exactly the live slots."""
    rng = np.random.default_rng(seed)
    l, cap, n0 = 6, 128, 80
    codes = rng.integers(0, 8, (l, cap)).astype(np.uint32)
    codes[:, n0:] = J.EMPTY_CODE
    ji, ti = _both(codes)
    live = np.arange(cap) < n0

    def step(mut_j, mut_t):
        nonlocal ji, ti
        ji = J.mutate_index(ji, mut_j)
        ti = T.mutate_index(ti, mut_t)
        _assert_index_equal(ti, ji)
        nl = int(live.sum())
        assert set(n(ti.order)[:, :nl].ravel().tolist()) == set(
            np.flatnonzero(live).tolist())

    def mutation(op, ids, codes=None):
        return (J.IndexMutation(op, ids=jnp.asarray(ids),
                                codes=None if codes is None
                                else jnp.asarray(codes)),
                T.IndexMutation(op, ids=t(ids, torch.int64),
                                codes=None if codes is None else t(codes)))

    new = np.flatnonzero(~live)[:20]                       # append
    ids, c = _padded(rng, new, rng.integers(0, 8, (l, 20)).astype(np.uint32))
    live[new] = True
    step(*mutation("append", ids, c))
    dirty = rng.choice(np.flatnonzero(live), 30, replace=False)   # delta
    ids, c = _padded(rng, dirty, rng.integers(0, 8, (l, 30)).astype(
        np.uint32))
    step(*mutation("delta", ids, c))
    gone = rng.choice(np.flatnonzero(live), 25, replace=False)    # evict
    live[gone] = False
    ids, _ = _padded(rng, gone, np.zeros((l, 25), np.uint32))
    step(*mutation("evict", ids))
    ji, ti = J.grow_index(ji, 256), T.grow_index(ti, 256)         # grow
    live = np.concatenate([live, np.zeros(128, bool)])
    _assert_index_equal(ti, ji)
    new = np.concatenate([gone[:5], np.arange(128, 140)])         # append
    ids, c = _padded(rng, new, rng.integers(0, 8, (l, 17)).astype(np.uint32))
    live[new] = True
    step(*mutation("append", ids, c))
    assert T.grow_index(ti, 256) is ti
    with pytest.raises(ValueError, match="compaction"):
        T.grow_index(ti, 64)


def test_all_dirty_delta_is_the_full_warm_refresh():
    """A delta of every row is bitwise the warm-started refresh on the
    same features (after tests/test_sharded_lgd.py:204), here and in the
    reference."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((90, 12)).astype(np.float32)
    x2 = x + 0.3 * rng.standard_normal(x.shape).astype(np.float32)
    jp = J.LSHParams(k=3, l=6, dim=12, family="dense")
    tp = T.LSHParams(k=3, l=6, dim=12, family="dense")
    ji = J.mutate_index(None, J.IndexMutation(
        "build", key=jax.random.PRNGKey(3), x_aug=jnp.asarray(x)), jp)
    ti = convert.index_from_numpy(*ji)
    full = T.mutate_index(ti, T.IndexMutation("refresh", x_aug=t(x2)), tp)
    ids = torch.arange(90)
    delta = T.mutate_index(ti, T.IndexMutation(
        "delta", ids=ids, codes=T.hash_points(t(x2), ti.projections, tp)))
    assert torch.equal(full.sorted_codes, delta.sorted_codes)
    assert torch.equal(full.order, delta.order)
    want = J.mutate_index(ji, J.IndexMutation("refresh",
                                              x_aug=jnp.asarray(x2)), jp)
    codes = T.hash_points(t(x2), ti.projections, tp)
    flips = assert_codes_match(codes.T, np.asarray(J.hash_points(
        jnp.asarray(x2), ji.projections, jp)).T, x2 @ np.asarray(
            ji.projections), 3)
    assert flips == 0
    _assert_index_equal(full, want)
    # a delta whose codes did not change keeps every slot
    same = _merge_impl(full, ids[:40], codes[:, :40])
    assert torch.equal(same.order, full.order)


# -- n_live draws against the reference ---------------------------------------

def _streaming_index(n_pts=256, n_live=8, d=10, k=8, l=4, seed=4):
    """A capacity-256 index with only ``n_live`` live rows scattered over
    it: most buckets are empty, so most walks fall back."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_pts, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    live = np.zeros(n_pts, bool)
    live[rng.choice(n_pts, n_live, replace=False)] = True
    jp = J.LSHParams(k=k, l=l, dim=d, family="dense")
    ji = J.mutate_index(None, J.IndexMutation(
        "build", key=jax.random.PRNGKey(seed), x_aug=jnp.asarray(x),
        live_mask=jnp.asarray(live)), jp)
    store = rng.integers(0, 997, (n_pts, 9)).astype(np.int32)
    return (jp, T.LSHParams(k=k, l=l, dim=d, family="dense"), x, live, ji,
            convert.index_from_numpy(*ji), store)


def _queries(tp, x, live, ti, hits):
    """Dead rows as queries whose exact buckets are non-empty in exactly
    ``hits[i]`` tables (0: every exact probe misses)."""
    out = []
    for want in hits:
        for i in np.flatnonzero(~live):
            lo, hi = T.bucket_bounds_batched(ti, t(x[i]), tp)
            if int((hi > lo).sum()) == want and i not in out:
                out.append(i)
                break
    return x[np.asarray(out)]


@pytest.mark.parametrize("mp", [0, 2])
def test_sample_n_live(mp):
    jp, tp, x, live, ji, ti, _ = _streaming_index()
    nl = int(live.sum())
    q = _queries(tp, x, live, ti, [0])[0]     # every exact bucket empty
    key = jax.random.PRNGKey(11 + mp)
    m, probes = 64, max(2 * jp.l, 8)
    want = J.sample(key, ji, jnp.asarray(x), jnp.asarray(q), jp, m=m,
                    multiprobe=mp, n_live=jnp.int32(nl), use_pallas=False)
    got = T.sample(None, ti, t(x), t(q), tp, m=m, multiprobe=mp, n_live=nl,
                   draws=jax_sample_draws(key, m, probes, jp.l, 256,
                                          n_live=nl))
    assert_results_match(got, want)
    fb = n(got.fallback)
    assert fb.mean() > 0.5
    assert live[n(got.indices)].all()
    np.testing.assert_array_equal(n(got.probs)[fb], np.float32(1.0 / nl))


def test_sample_batched_and_gather_n_live():
    jp, tp, x, live, ji, ti, store = _streaming_index(seed=6)
    nl = int(live.sum())
    qs = _queries(tp, x, live, ti, [0, 1, 0])
    key = jax.random.PRNGKey(21)
    m, probes = 16, max(2 * jp.l, 8)
    draws = jax_sample_draws(key, m, probes, jp.l, 256, batch=3, n_live=nl)
    want = J.sample_batched(key, ji, jnp.asarray(x), jnp.asarray(qs), jp,
                            m=m, n_live=jnp.int32(nl), use_pallas=False)
    got = T.sample_batched(None, ti, t(x), t(qs), tp, m=m, n_live=nl,
                           draws=draws)
    assert_results_match(got, want)
    for normalize in (False, True):
        wb = J.sample_gather_batched(
            key, ji, jnp.asarray(x), jnp.asarray(qs), jnp.asarray(store), jp,
            m=m, normalize=normalize, n_live=jnp.int32(nl), use_pallas=False)
        gb = T.sample_gather_batched(
            None, ti, t(x), t(qs), t(store), tp, m=m, normalize=normalize,
            n_live=nl, draws=draws)
        for f in ("tokens", "example_ids", "fallback"):
            np.testing.assert_array_equal(
                n(getattr(gb, f)).astype(np.int64),
                np.asarray(getattr(wb, f)).astype(np.int64), err_msg=f)
        np.testing.assert_allclose(n(gb.loss_weights),
                                   np.asarray(wb.loss_weights), rtol=RTOL,
                                   atol=ATOL)
    fb = n(gb.fallback)
    assert fb.mean() > 0.5 and (~fb).any()


# -- the streaming pipeline against the reference -----------------------------

def test_pipeline_mutations_and_draws_match_the_reference():
    """Appends (one past the window), an explicit evict and draws with
    the reference's draws through a refresh: membership, store and index
    bitwise, tokens and ids bitwise, weights rtol 1e-5."""
    toks = _tokens(96)
    ref = _ref_pipe(toks, window=100, refresh_every=4)
    got = _pipe(toks, window=100, refresh_every=4,
                projections=t(ref.index.projections))
    np.testing.assert_array_equal(n(got.features), np.asarray(ref.features))
    proj = np.asarray(ref.features) @ np.asarray(ref.index.projections)
    assert assert_codes_match(
        T.hash_points(got.features, got.index.projections, got.lsh).T,
        np.asarray(J.hash_points(ref.features, ref.index.projections,
                                 ref.lsh)).T, proj, 4) == 0

    def same():
        np.testing.assert_array_equal(got._live_np, ref._live_np)
        np.testing.assert_array_equal(got._arrival, ref._arrival)
        np.testing.assert_array_equal(n(got.store), np.asarray(ref.store))
        _assert_index_equal(got.index, ref.index)
        _assert_live_prefix(got)

    stream = jax.random.fold_in(jax.random.PRNGKey(7), SALT_STEP)
    for step in range(7):
        if step == 1:
            extra = _tokens(10, seed=30)       # 6 past the window of 100
            np.testing.assert_array_equal(got.append_rows(extra),
                                          ref.append_rows(extra))
            same()
        if step == 3:
            gone = np.flatnonzero(got._live_np)[5:12]
            got.evict_rows(gone)
            ref.evict_rows(gone)
            same()
        nl = got.n_live
        draws = jax_sample_draws(jax.random.fold_in(stream, step), 8,
                                 max(2 * got.lsh.l, 8), got.lsh.l,
                                 got.capacity, n_live=nl)
        bj, bt = ref.next_batch(), got.next_batch(draws=draws)
        for k in ("tokens", "targets", "example_ids"):
            np.testing.assert_array_equal(
                n(bt[k]).astype(np.int64), np.asarray(bj[k]).astype(
                    np.int64), err_msg=k)
        np.testing.assert_allclose(n(bt["loss_weights"]),
                                   np.asarray(bj["loss_weights"]), rtol=RTOL)
    assert got._refresh_count == ref._refresh_count == 1
    same()


def test_cumulative_fallback_rate_matches_the_reference():
    """A streaming SMOKE run (appends past the window, an evict, refreshes
    every 4 steps) whose sparse K 8 buckets send many draws to the
    uniform fallback: the cumulative diagnostics equal the reference's."""
    toks = _tokens(96)
    ref = _ref_pipe(toks, window=100, refresh_every=4, k=8)
    got = _pipe(toks, window=100, refresh_every=4, k=8,
                projections=t(ref.index.projections))
    stream = jax.random.fold_in(jax.random.PRNGKey(7), SALT_STEP)
    for step in range(12):
        if step == 2:
            extra = _tokens(10, seed=31)
            got.append_rows(extra)
            ref.append_rows(extra)
        if step == 5:
            gone = np.flatnonzero(got._live_np)[3:96]
            got.evict_rows(gone)
            ref.evict_rows(gone)
        draws = jax_sample_draws(jax.random.fold_in(stream, step), 8,
                                 max(2 * got.lsh.l, 8), got.lsh.l,
                                 got.capacity, n_live=got.n_live)
        ref.next_batch()
        got.next_batch(draws=draws)
    want, have = ref.sampler_stats(), got.sampler_stats()
    assert have["draws"] == want["draws"] == 96
    for k in ("fallback_rate", "primary_miss_rate", "last_fallback_rate"):
        assert have[k] == pytest.approx(want[k], rel=0, abs=1e-12), k
    assert 0 < have["fallback_rate"] < 1 and have["primary_miss_rate"] > 0
    assert got._refresh_count == ref._refresh_count == 2
    st = got.index_stats()
    assert st["fallback_rate"] == have["fallback_rate"]
    # the distinct buckets a table over the live prefix, as counted on the
    # reference's index
    sc = np.asarray(ref.index.sorted_codes)[:, :ref.n_live]
    want_b = [len(np.unique(row)) for row in sc]
    assert st["buckets_per_table"] == want_b
    q = np.asarray(ref._query(), np.float64)
    live = np.asarray(ref.features, np.float64)[ref._live_np]
    mean = live.mean(0)
    cos = float(q @ mean / (np.linalg.norm(q) * np.linalg.norm(mean)))
    assert st["query_feature_cos"] == pytest.approx(cos, abs=1e-5)


# -- the reference's streaming contracts (tests/test_streaming.py) ------------

class TestAppendEvict:
    def test_append_equals_fresh_build_membership(self):
        pipe = _pipe(_tokens(48))
        extra = _tokens(16, seed=11)
        assert pipe.append_rows(extra).shape == (16,)
        assert pipe.n_live == 64
        _assert_live_prefix(pipe)
        fresh = _pipe(np.concatenate([_tokens(48), extra]))
        assert _live_sets(pipe.index, 64) == _live_sets(fresh.index, 64)

    def test_evict_all_then_append_equals_fresh_build(self):
        pipe = _pipe(_tokens(32))
        pipe.evict_rows(np.arange(32))
        assert pipe.n_live == 0
        with pytest.raises(RuntimeError, match="empty streaming window"):
            pipe.next_batch()
        fresh_tokens = _tokens(32, seed=23)
        pipe.append_rows(fresh_tokens)
        _assert_live_prefix(pipe)
        fresh = _pipe(fresh_tokens)
        assert torch.equal(pipe.index.sorted_codes[:, :32],
                           fresh.index.sorted_codes[:, :32])
        assert _live_sets(pipe.index, 32) == _live_sets(fresh.index, 32)
        assert torch.equal(pipe.store[:32], fresh.store[:32])

    def test_append_then_evict_restores_bucket_membership(self):
        pipe = _pipe(_tokens(48))
        before = _live_sets(pipe.index, 48)
        pipe.evict_rows(pipe.append_rows(_tokens(8, seed=13)))
        assert pipe.n_live == 48
        assert _live_sets(pipe.index, 48) == before
        _assert_live_prefix(pipe)

    def test_window_auto_evicts_oldest(self):
        pipe = _pipe(_tokens(24), window=24)
        pipe.append_rows(_tokens(6, seed=17))
        assert pipe.n_live == 24
        assert pipe._arrival[pipe._live_np].min() == 6
        _assert_live_prefix(pipe)
        with pytest.raises(ValueError, match="exceeds window"):
            pipe.append_rows(_tokens(25, seed=18))


class TestCapacity:
    def test_grow_doubles_capacity(self):
        pipe = _pipe(_tokens(60), min_capacity=64)
        assert pipe.capacity == 64
        pipe.append_rows(_tokens(8, seed=19))
        assert pipe.capacity == 128 and pipe.n_live == 68
        assert pipe.features.shape[0] == pipe.index.n_points == 128
        _assert_live_prefix(pipe)

    def test_compaction_shrinks_capacity(self):
        pipe = _pipe(_tokens(60), min_capacity=16)
        assert pipe.capacity == 64
        pipe.evict_rows(np.arange(52))
        assert pipe.n_live == 8 and pipe.capacity == 16
        _assert_live_prefix(pipe)
        assert pipe.next_batch()["tokens"].shape == (8, SEQ - 1)


def _batch_value(tokens_2d):
    """A per-example value computable from a batch's tokens or a stored
    row's input slice."""
    return EMBED[np.asarray(tokens_2d)].mean(axis=(1, 2)) + 2.0


@pytest.mark.statistical
def test_weighted_mean_tracks_moving_window():
    """E[w v] = mean(v) over the LIVE window as it slides: every 1/(p N)
    weight uses the live N (after tests/test_streaming.py:184).  Algorithm
    1's p is an expectation over hash functions, so the estimate averages
    over index builds (24 seeds x 10 batches at each window position) and
    must lie in the 3-sigma band of the truth; the calibrated K 3 / L 64
    regime, no fallbacks."""
    rounds, seeds = 3, 24
    est = np.zeros((rounds, seeds))
    truths = []
    for seed in range(seeds):
        pipe = _pipe(_tokens(64, seed=3), seed=seed, k=3, l=64, minibatch=16,
                     normalize_weights=False, window=64)
        for rnd in range(rounds):
            pipe.append_rows(_tokens(8, seed=100 + rnd))
            if seed == 0:
                live = np.flatnonzero(pipe._live_np)
                truths.append(float(np.mean(_batch_value(
                    n(pipe.store)[live][:, :SEQ - 1]))))
            est[rnd, seed] = np.mean([np.mean(
                n(b["loss_weights"]).astype(np.float64)
                * _batch_value(n(b["tokens"])))
                for b in (pipe.next_batch() for _ in range(10))])
        assert pipe.sampler_stats()["fallback_rate"] < 0.05   # regime guard
    assert len(set(truths)) == rounds              # the window moved
    for rnd in range(rounds):
        assert abs(est[rnd].mean() - truths[rnd]) <= mean_band(
            est[rnd].std(ddof=1), seeds), (rnd, est[rnd].mean(), truths[rnd])


class TestRestoreReplay:
    def test_restored_pipelines_draw_bit_identical_batches(self):
        pipe = _pipe(_tokens(48), window=48, refresh_every=3)
        for _ in range(2):
            pipe.next_batch()
        pipe.append_rows(_tokens(6, seed=31))
        for _ in range(3):
            pipe.next_batch()
        pipe.evict_rows(pipe.append_rows(_tokens(2, seed=37))[:1])
        step = pipe._step
        log = json.loads(json.dumps(pipe.mutation_log()))
        live_before = pipe._live_np.copy()
        pipe.restore_at(step)
        np.testing.assert_array_equal(pipe._live_np, live_before)
        expect = [pipe.next_batch() for _ in range(4)]
        other = _pipe(_tokens(48), window=48, refresh_every=3)
        other.load_mutation_log(log)
        other.restore_at(step)
        np.testing.assert_array_equal(other._live_np, live_before)
        assert torch.equal(other.index.sorted_codes, pipe.index.sorted_codes)
        assert torch.equal(other.index.order, pipe.index.order)
        for want in expect:
            got = other.next_batch()
            for k in want:
                assert torch.equal(got[k], want[k]), k

    def test_restore_is_idempotent_and_truncates_log(self):
        pipe = _pipe(_tokens(32), window=32)
        pipe._step = 5
        pipe.append_rows(_tokens(4, seed=41))
        pipe._step = 9
        pipe.append_rows(_tokens(4, seed=43))
        pipe.restore_at(7)                   # drops the step-9 append
        assert len(pipe.mutation_log()) == 1
        first, live = pipe.index.sorted_codes.clone(), pipe._live_np.copy()
        pipe.restore_at(7)
        assert torch.equal(first, pipe.index.sorted_codes)
        np.testing.assert_array_equal(live, pipe._live_np)
        with pytest.raises(ValueError, match="unknown mutation-log op"):
            pipe.load_mutation_log([{"op": "grow", "step": 1}])


class TestMutationSurface:
    def test_mutation_api_requires_streaming(self):
        pipe = _pipe(_tokens(24), streaming=False)
        for call in (lambda: pipe.append_rows(_tokens(2)),
                     lambda: pipe.evict_rows(np.asarray([0])),
                     lambda: pipe.load_mutation_log([])):
            with pytest.raises(ValueError, match="streaming"):
                call()

    def test_mutate_entry_point_routes_all_ops(self):
        pipe = _pipe(_tokens(32))
        gids = pipe.mutate(T.IndexMutation("append",
                                           tokens=_tokens(2, seed=71)))
        assert gids.shape == (2,) and pipe.n_live == 34
        pipe.mutate(T.IndexMutation("evict", ids=gids))
        assert pipe.n_live == 32
        assert pipe.mutate(T.IndexMutation("refresh"))
        assert pipe.mutate(T.IndexMutation("delta"))
        assert pipe.mutate(T.IndexMutation("build"))
        assert pipe._refresh_count == 2
        _assert_live_prefix(pipe)
        with pytest.raises(ValueError, match="needs tokens"):
            pipe.mutate(T.IndexMutation("append"))
        with pytest.raises(ValueError, match="duplicate"):
            pipe.evict_rows(np.asarray([3, 3]))
        with pytest.raises(ValueError, match="already-dead"):
            pipe.evict_rows(np.asarray([40]))
