"""Shard-by-example LGD in the port against the JAX package, on the CPU.

The port's ``ShardedLSHPipeline`` is held against
``repro.data.ShardedLSHPipeline`` built WITHOUT a mesh (the reference's
launcher fails under JAX 0.9, so its CLI is never the oracle):

* ``example_shard_bounds`` bitwise over a grid of (n, S);
* per-shard batches on the reference shards' projections and draws
  (shard s's step key is ``fold_in(fold_in(fold_in(key, s), 0x057E9),
  step)``): ``tokens``, ``targets``, ``example_ids`` and ``shard_ids``
  bitwise, the composed weights at the golden-pin tolerance (rtol 1e-5,
  atol 1e-7), with ``normalize_weights`` on and off, uneven shards, a
  refresh, and a streaming case whose appends and evicts route to the
  same shards and return the same global ids.  The features are sums of
  an integer embedding, exact in both packages;
* the composition identity of tests/test_sharded_lgd.py on the port,
  exactly (rtol 1e-9), and E[mean w] = 1 over index builds;
* ownership and adoption (the port alone, after tests/test_multihost.py):
  partial owners compose bitwise into full ownership, adoption equals
  full ownership, the refusals, the fault injector's global shard ids;
* ``rebuild_sharded_pipeline``, ``rescale_plan`` and
  ``ClusterHealthMonitor`` against the reference's;
* the launchers: ``train_lm --shards 2`` and ``launch.train --lgd``.
"""

import contextlib
import io
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data as JD
from _stats import mean_band
from _torch_parity import (ATOL, RTOL, assert_codes_match, jax_sample_draws,
                           n, t)
from repro.core import hash_points as j_hash_points
from repro.data.health import ClusterHealthMonitor as JClusterHealthMonitor
from repro.dist.sharding import example_shard_bounds as j_bounds
from repro.train.elastic import rescale_plan as j_rescale_plan
from repro_torch import train_lm
from repro_torch.core import hash_points
from repro_torch.data import (CLUSTER_DEGRADED, CLUSTER_HEALTHY,
                              CLUSTER_REFORMED, ClusterHealthMonitor,
                              LSHPipelineConfig, ShardedLSHPipeline,
                              lm_head_query_fn, make_token_corpus,
                              mean_pool_feature_fn)
from repro_torch.data.lsh_pipeline import _SHARD_STRIDE
from repro_torch.dist import compose_sharded_batch, example_shard_bounds
from repro_torch.launch import train as launch_train
from repro_torch.models import LM, ModelConfig
from repro_torch.optim import Adam
from repro_torch.testing import RefreshRaise
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train.elastic import (rebuild_sharded_pipeline,
                                       rescale_plan,
                                       restore_latest_valid_on_mesh)

VOCAB, DIM, SEQ = 50, 16, 9
# integer embeddings: the features (sums, norms) are exact in both packages
EMBED = np.random.default_rng(1).integers(-4, 5, (VOCAB, DIM)).astype(
    np.float32)
QUERY = np.random.default_rng(2).standard_normal(DIM).astype(np.float32)
JPARAMS = {"embed": jnp.asarray(EMBED), "q": jnp.asarray(QUERY)}
TPARAMS = {"embed": torch.from_numpy(EMBED.copy()),
           "q": torch.from_numpy(QUERY.copy())}
SALT_STEP = 0x057E9
KEYS = ("tokens", "targets", "example_ids", "shard_ids")


def j_feature_fn(params, chunk):
    return jnp.sum(params["embed"][chunk], axis=1)


def t_feature_fn(params, chunk):
    return params["embed"][chunk].sum(1)


def query_fn(params):
    return params["q"]


def _tokens(n_rows=128, seed=2):
    return np.random.default_rng(seed).integers(
        0, VOCAB, (n_rows, SEQ)).astype(np.int32)


def _cfg(make, **kw):
    for k, v in dict(k=4, l=8, minibatch=16, refresh_every=0).items():
        kw.setdefault(k, v)
    return make(**kw)


def _pipe(tokens=None, n_shards=4, seed=7, **kw):
    """The port's pipeline, on its own streams."""
    cfg_kw = {k: kw.pop(k) for k in list(kw)
              if k not in ("owned_shards", "projections")}
    return ShardedLSHPipeline(
        seed, _tokens() if tokens is None else tokens, t_feature_fn,
        query_fn, _cfg(LSHPipelineConfig, **cfg_kw), n_shards=n_shards,
        params=TPARAMS, device="cpu", **kw)


def _pair(tokens, n_shards, seed=7, **kw):
    """(reference, port) on the reference shards' projections; every
    shard's features equal and its codes equal (no projection near zero
    at these seeds), so its index is bitwise the reference's."""
    ref = JD.ShardedLSHPipeline(
        jax.random.PRNGKey(seed), tokens, j_feature_fn, query_fn,
        _cfg(JD.LSHPipelineConfig, use_pallas=False, **kw),
        n_shards=n_shards, params=JPARAMS)
    got = _pipe(tokens, n_shards, seed,
                projections=[t(p.index.projections) for p in ref.shards],
                **kw)
    for pj, pt in zip(ref.shards, got.shards):
        np.testing.assert_array_equal(n(pt.features), np.asarray(pj.features))
        proj = np.asarray(pj.features) @ np.asarray(pj.index.projections)
        assert assert_codes_match(
            hash_points(pt.features, pt.index.projections, pt.lsh).T,
            np.asarray(j_hash_points(pj.features, pj.index.projections,
                                     pj.lsh)).T, proj, 4) == 0
        np.testing.assert_array_equal(n(pt.index.order),
                                      np.asarray(pj.index.order))
    return ref, got


def _draws(seed, pipe, step):
    """The reference's draws of every shard at ``step``."""
    out = []
    for s, p in zip(pipe.owned, pipe.shards):
        key = jax.random.fold_in(jax.random.fold_in(
            jax.random.fold_in(jax.random.PRNGKey(seed), s), SALT_STEP), step)
        out.append(jax_sample_draws(
            key, p.cfg.minibatch, max(2 * p.lsh.l, 8), p.lsh.l, p.capacity,
            n_live=p.n_live if p.streaming else None))
    return out


def _same_batch(bt, bj):
    for k in KEYS:
        np.testing.assert_array_equal(
            n(bt[k]).astype(np.int64), np.asarray(bj[k]).astype(np.int64),
            err_msg=k)
    np.testing.assert_allclose(n(bt["loss_weights"]),
                               np.asarray(bj["loss_weights"]), rtol=RTOL,
                               atol=ATOL)


# -- bounds and composition ---------------------------------------------------

@pytest.mark.parametrize("n_rows", [1, 5, 7, 96, 128, 130, 1023])
def test_example_shard_bounds_bitwise(n_rows):
    for s_count in range(1, 9):
        for s in range(s_count):
            assert example_shard_bounds(n_rows, s, s_count) == j_bounds(
                n_rows, s, s_count)
    for bad in (-1, 4):
        with pytest.raises(ValueError):
            example_shard_bounds(n_rows, bad, 4)


def test_compose_sharded_batch_is_shard_order():
    parts = [torch.full((2, 3), s) for s in range(3)]
    got = compose_sharded_batch(parts, "cpu")
    assert torch.equal(got, torch.cat(parts))


# -- batches against the reference --------------------------------------------

@pytest.mark.parametrize("n_rows,n_shards,kw", [
    (128, 4, dict(refresh_every=3)),             # mean-1 normalised
    (130, 4, dict(normalize_weights=False)),     # uneven shards: 33/33/32/32
    (96, 2, dict(normalize_weights=False, refresh_every=2,
                 refresh_async=True)),
    (97, 1, dict()),
], ids=["normalised-refresh", "uneven-raw", "async-raw", "one-shard"])
def test_batches_match_the_reference(n_rows, n_shards, kw):
    toks = _tokens(n_rows)
    ref, got = _pair(toks, n_shards, **kw)
    for step in range(5):
        bj = ref.next_batch()
        bt = got.next_batch(draws=_draws(7, got, step))
        _same_batch(bt, bj)
    assert got.health_summary() == ref.health_summary()
    st_t, st_j = got.sampler_stats(), ref.sampler_stats()
    assert st_t["draws"] == st_j["draws"] == 80
    for k in ("fallback_rate", "primary_miss_rate"):
        assert st_t[k] == pytest.approx(st_j[k], rel=1e-12)
    got.finalize()
    ref.finalize()


def test_streaming_routing_and_batches_match_the_reference():
    """Appends routed to the least-live shard (ties to the lowest id), a
    window per shard, an explicit evict by global id: the returned gids,
    each shard's membership and the composed batches (live counts in the
    weights) equal the reference's."""
    toks = _tokens(96)
    ref, got = _pair(toks, 2, window=100, normalize_weights=False)
    for step in range(6):
        if step == 1:
            extra = _tokens(9, seed=30)            # 5 past the window of 100
            np.testing.assert_array_equal(got.append_rows(extra),
                                          ref.append_rows(extra))
        if step == 3:
            gone = np.asarray([3, 9, _SHARD_STRIDE + 4, _SHARD_STRIDE + 40])
            got.evict_rows(gone)
            ref.evict_rows(gone)
            extra = _tokens(3, seed=31)            # refills shard 1 first
            np.testing.assert_array_equal(got.append_rows(extra),
                                          ref.append_rows(extra))
        for pt, pj in zip(got.shards, ref.shards):
            assert pt.n_live == pj.n_live
            np.testing.assert_array_equal(pt._live_np, pj._live_np)
            np.testing.assert_array_equal(n(pt.store), np.asarray(pj.store))
            np.testing.assert_array_equal(n(pt.index.order),
                                          np.asarray(pj.index.order))
        bt = got.next_batch(draws=_draws(7, got, step))
        _same_batch(bt, ref.next_batch())
    assert [p.n_live for p in got.shards] == [
        p.n_live for p in ref.shards] == [50, 49]
    log = got.mutation_log()
    assert log["n_shards"] == 2 and log == _jsonable(ref.mutation_log())
    with pytest.raises(ValueError, match="outside any shard"):
        got.evict_rows([2 * _SHARD_STRIDE])


def _jsonable(log):
    return {"n_shards": log["n_shards"],
            "shards": [[{k: (np.asarray(v).tolist()
                             if k in ("tokens", "ids") else int(v)
                             if k == "step" else v) for k, v in e.items()}
                        for e in s] for s in log["shards"]]}


# -- the estimator on the port ------------------------------------------------

def test_per_shard_means_average_to_global_mean_exactly():
    """tests/test_sharded_lgd.py's composition identity on the port: the
    plain mean of the composed weights w = S/(p N) times v equals the
    average over shards of the shard means taken with the local weights
    1/(p n_s) rescaled by n_s S / N."""
    tokens = _tokens(96, seed=3)
    v = EMBED[tokens[:, :-1]].mean(axis=(1, 2)).astype(np.float64) + 2.0
    pipe = _pipe(tokens, 4, normalize_weights=False)
    n_rows, s_count = 96, 4
    for _ in range(5):
        b = pipe.next_batch()
        w = n(b["loss_weights"]).astype(np.float64)
        ids, sh = n(b["example_ids"]), n(b["shard_ids"])
        global_est = np.mean(w * v[ids])
        per_shard = []
        for s in range(s_count):
            lo, hi = example_shard_bounds(n_rows, s, s_count)
            m = sh == s
            local_w = w[m] * n_rows / ((hi - lo) * s_count)   # 1/(p n_s)
            per_shard.append(np.mean(local_w * v[ids[m]]) * (hi - lo)
                             * s_count / n_rows)
        np.testing.assert_allclose(global_est, np.mean(per_shard), rtol=1e-9)


@pytest.mark.statistical
def test_composed_weights_unbiased_over_index_builds():
    """Sharding adds no bias: E[mean w] with raw weights w = S/(p N) is 1
    for S 4 and for S 1, the expectation over index builds (seeds) and
    draws (Algorithm 1's p averages over the hash functions).  The
    calibrated regime is set by the rows a SHARD holds: 130 rows over 4
    shards leave ~32 a shard, so K 2 (8 rows a bucket; no fallback), L
    32; at K 3 both S 4 and S 1 read ~1.12 here, the finite-K offset the
    reference's estimator tests note.  Measured at these seeds: per-build
    sd of the 10-batch mean 0.071 (S 4) and 0.113 (S 1) over 30 builds;
    each band is 3 sigma."""
    tokens = _tokens(130, seed=3)
    means = {}
    for s_count in (4, 1):
        ests, fallback = [], 0.0
        for seed in range(30):
            pipe = _pipe(tokens, s_count, seed=seed, k=2, l=32,
                         normalize_weights=False)
            ests.append(np.mean([
                float(pipe.next_batch()["loss_weights"].double().mean())
                for _ in range(10)]))
            fallback = max(fallback, pipe.sampler_stats()["fallback_rate"])
        assert fallback < 0.05                                # regime guard
        means[s_count] = (np.mean(ests), np.std(ests))
        assert abs(np.mean(ests) - 1.0) <= mean_band(np.std(ests), len(ests))
    (m4, sd4), (m1, sd1) = means[4], means[1]
    assert abs(m4 - m1) <= mean_band(np.hypot(sd4, sd1), 30)


# -- ownership and adoption (tests/test_multihost.py, on the port) ------------

def _cat(batches, key):
    return torch.cat([b[key] for b in batches])


def test_partial_owners_compose_bitwise():
    full = _pipe(n_shards=2, normalize_weights=False, refresh_every=3)
    parts = [_pipe(n_shards=2, normalize_weights=False, refresh_every=3,
                   owned_shards=[s]) for s in (0, 1)]
    for _ in range(6):
        g = full.next_batch()
        got = [p.next_batch() for p in parts]
        for k in KEYS + ("loss_weights",):
            assert torch.equal(g[k], _cat(got, k)), k


def test_adoption_equals_full_ownership_bitwise():
    k = 5
    full = _pipe(n_shards=4, normalize_weights=False, refresh_every=4)
    part = _pipe(n_shards=4, normalize_weights=False, refresh_every=4,
                 owned_shards=[0, 2])
    for _ in range(k):
        full.next_batch()
        part.next_batch()
    part.adopt_shards([3, 1], step=k)
    assert part.owned == [0, 1, 2, 3]
    for _ in range(6):
        g, a = full.next_batch(), part.next_batch()
        for key in KEYS + ("loss_weights",):
            assert torch.equal(g[key], a[key]), key
    monitor = ClusterHealthMonitor()
    monitor.note_host_lost(k, [1, 3], "stale heartbeat")
    for s in (1, 3):
        monitor.note_adopted(k, s, by_rank=0)
    assert monitor.degraded and [e[1] for e in monitor.events] == [
        "host-lost", "shard-adopted", "shard-adopted"]


def test_partial_owner_refusals_and_adoption_errors():
    with pytest.raises(ValueError, match="owned_shards must not"):
        _pipe(n_shards=2, owned_shards=[])
    with pytest.raises(ValueError, match=r"not in \[0, 2\)"):
        _pipe(n_shards=2, owned_shards=[2])
    with pytest.raises(ValueError, match="normalize_weights"):
        _pipe(n_shards=2, owned_shards=[0])
    with pytest.raises(ValueError, match="streaming"):
        _pipe(n_shards=2, owned_shards=[0], window=48,
              normalize_weights=False)
    with pytest.raises(ValueError, match="must divide by"):
        _pipe(n_shards=3)
    with pytest.raises(ValueError, match="window=50 must divide"):
        _pipe(n_shards=4, window=50)
    part = _pipe(n_shards=2, owned_shards=[0], normalize_weights=False)
    with pytest.raises(ValueError, match="already owned"):
        part.adopt_shards([0], step=0)
    with pytest.raises(ValueError, match=r"not in \[0, 2\)"):
        part.adopt_shards([2], step=0)
    stream = _pipe(n_shards=2, window=48)
    with pytest.raises(ValueError, match="static corpus"):
        stream.adopt_shards([1], step=0)
    with pytest.raises(ValueError, match="requires streaming"):
        part.append_rows(_tokens(2))


def test_fault_injector_takes_global_shard_ids():
    """An injector on global shard 1 of a partial owner fails that
    shard's refreshes only; shard 0 of another owner is refused."""
    p1 = _pipe(n_shards=2, owned_shards=[1], normalize_weights=False,
               refresh_every=2, refresh_retries=0, refresh_backoff=0.0)
    with pytest.raises(ValueError, match="not owned here"):
        p1.set_fault_injector(RefreshRaise(), shard=0)
    p1.set_fault_injector(RefreshRaise(), shard=1)
    for _ in range(3):
        p1.next_batch()
    hs = p1.health_summary()
    assert hs["state"] == "stale-index" and hs["refresh_failures"] == 1
    assert [tr[0] for tr in hs["transitions"]] == [1]
    both = _pipe(n_shards=2, normalize_weights=False, refresh_every=2,
                 refresh_retries=0, refresh_backoff=0.0)
    both.set_fault_injector(RefreshRaise(), shard=1)
    for _ in range(3):
        both.next_batch()
    assert both.health_state() == "stale-index"
    assert [p.health.state for p in both.shards] == ["healthy",
                                                     "stale-index"]


# -- elastic restore ----------------------------------------------------------

def test_rebuild_twice_is_bitwise_alike():
    """Two rebuilds onto S 2 at step 7 (a reshape from S 4) draw the same
    batches, and they are the live S 2 pipeline's from step 7 on when
    the params never changed."""
    tokens = _tokens(120, seed=9)
    kw = dict(refresh_every=4, refresh_mode="delta", drift_frac=0.3)
    live = _pipe(tokens, 2, **kw)
    for _ in range(7):
        live.next_batch()
    a, b = (rebuild_sharded_pipeline(
        7, tokens, t_feature_fn, query_fn, _cfg(LSHPipelineConfig, **kw),
        step=7, n_shards=2, params=TPARAMS, device="cpu") for _ in range(2))
    assert all(p._refresh_count == 1 for p in a.shards)
    for _ in range(6):
        bl, ba, bb = live.next_batch(), a.next_batch(), b.next_batch()
        for k in KEYS + ("loss_weights",):
            assert torch.equal(ba[k], bb[k]) and torch.equal(ba[k], bl[k])


def test_rebuild_checks_the_logged_shard_count_first():
    calls = []

    def counting(params, chunk):
        calls.append(1)
        return t_feature_fn(params, chunk)

    with pytest.raises(ValueError, match="recorded shard layout"):
        rebuild_sharded_pipeline(
            7, _tokens(), counting, query_fn,
            _cfg(LSHPipelineConfig, window=48, normalize_weights=False),
            step=4, n_shards=1, mutation_log={"n_shards": 2,
                                              "shards": [[], []]},
            params=TPARAMS, device="cpu")
    assert not calls                                  # before any build
    pipe = _pipe(n_shards=2, window=48)
    with pytest.raises(ValueError, match="n_shards=3"):
        pipe.load_mutation_log({"n_shards": 3, "shards": [[]] * 3})


TINY = ModelConfig(name="tiny", n_layers=1, d_model=32, n_heads=4,
                   n_kv_heads=2, d_ff=64, vocab=64, chunk=16, loss_chunk=16,
                   dtype="float32", rope_theta=10000.0)


def test_mutation_log_round_trips_through_a_checkpoint(tmp_path):
    """A streaming S 2 pipeline under the Trainer: rows appended and
    evicted by global id from a step hook, a checkpoint at step 4 whose
    extra holds the sharded log (its n_shards and per-shard entries).  A
    resumed trainer on a fresh pipeline replays it, and so does
    ``rebuild_sharded_pipeline`` from ``restore_latest_valid_on_mesh``:
    the same membership and store in every shard, the same next batch."""
    corpus = make_token_corpus(5, 64, 16, TINY.vocab).tokens
    new_rows = make_token_corpus(6, 6, 16, TINY.vocab).tokens
    pcfg = LSHPipelineConfig(k=4, l=8, minibatch=8, refresh_every=0,
                             window=64)

    def pipeline():
        return ShardedLSHPipeline(
            2, corpus, mean_pool_feature_fn(TINY), lm_head_query_fn(), pcfg,
            n_shards=2, params=LM.init(TINY, seed=0, device="cpu"),
            device="cpu")

    def hook(tr):
        if tr.step == 2:
            tr.sampler.append_rows(new_rows)
            tr.sampler.evict_rows([3, _SHARD_STRIDE + 5])

    def trainer(pipe):
        return Trainer(TINY, pipe.params, Adam(lr=1e-2), sampler=pipe,
                       tcfg=TrainerConfig(ckpt_dir=str(tmp_path),
                                          ckpt_every=4, step_hook=hook))

    live = pipeline()
    tr = trainer(live)
    tr.run(4)
    tr.finalize()
    step, state, extra = restore_latest_valid_on_mesh(str(tmp_path),
                                                      tr._state_tree())
    log = extra["mutation_log"]
    assert step == 4 and log["n_shards"] == 2 and len(log["shards"]) == 2
    assert log == live.mutation_log()
    resumed = trainer(pipeline())
    assert resumed.step == 4
    rebuilt = rebuild_sharded_pipeline(
        2, corpus, mean_pool_feature_fn(TINY), lm_head_query_fn(), pcfg,
        step=4, n_shards=2, params=resumed.params, mutation_log=log,
        device="cpu")
    for pipe in (resumed.sampler, rebuilt):
        assert pipe.mutation_log() == log
        for pa, pb in zip(live.shards, pipe.shards):
            assert pa.n_live == pb.n_live
            np.testing.assert_array_equal(pa._live_np, pb._live_np)
            assert torch.equal(pa.store, pb.store)
    a, b = resumed.sampler.next_batch(), rebuilt.next_batch()
    for k in KEYS + ("loss_weights",):
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("old", [1, 2, 3, 4, 8, 16])
def test_rescale_plan_matches_the_reference(old):
    for new in (1, 2, 3, 4, 6, 8, 16, 32):
        for gb in (8, 12, 48, 64):
            try:
                want = j_rescale_plan(old, new, gb)
            except ValueError as e:
                with pytest.raises(ValueError, match="does not divide"):
                    rescale_plan(old, new, gb)
                assert "does not divide" in str(e)
                continue
            assert rescale_plan(old, new, gb) == want
    for bad in ((0, 2, 8), (2, -1, 8)):
        with pytest.raises(ValueError, match="positive"):
            rescale_plan(*bad)
        with pytest.raises(ValueError, match="positive"):
            j_rescale_plan(*bad)


def test_cluster_health_monitor_matches_the_reference():
    got, want = ClusterHealthMonitor(), JClusterHealthMonitor()
    assert got.state == want.state == CLUSTER_HEALTHY
    for m in (got, want):
        m.note_host_lost(15, [3, 1], "stale heartbeat")
        m.note_adopted(15, 1, by_rank=0)
        m.note_adopted(15, 3, by_rank=2)
        m.note_host_lost(16, [2])                  # no new edge
        m.note_reformed(20, 2)
        m.note_reformed(21, 2)                     # counted, no new edge
        m.note_host_lost(30, [0], "barrier timeout")
    assert got.summary() == want.summary()
    assert got.degraded and got.state == CLUSTER_DEGRADED
    assert [tr[2] for tr in got.transitions] == [
        CLUSTER_DEGRADED, CLUSTER_REFORMED, CLUSTER_DEGRADED]
    assert got.reforms == 2 and got.lost_hosts == [1, 3, 2, 0]


# -- the launchers ------------------------------------------------------------

def test_train_lm_shards_trains(monkeypatch):
    """``train_lm --shards 2`` draws through a two-shard pipeline and
    trains with finite losses (the trainer's own, recorded here)."""
    args = train_lm.parse_args(["--shards", "2"])
    assert args.shards == 2
    losses, run = [], Trainer.run

    def recorded(self, n_steps):
        out = run(self, n_steps)
        losses.extend(out["losses"])
        return out

    monkeypatch.setattr(Trainer, "run", recorded)
    # the demo preset with a 256-row corpus: one index build of 4,096 rows
    # costs minutes under the parallel test run
    monkeypatch.setitem(train_lm.PRESETS, "demo",
                        dict(train_lm.PRESETS["demo"], corpus=256))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tr = train_lm.main(["--device", "cpu", "--shards", "2", "--steps",
                            "3"])
    assert isinstance(tr.sampler, ShardedLSHPipeline)
    assert tr.sampler.n_shards == 2 and tr.step == 3
    assert tr.sampler.sampler_stats()["draws"] == 48
    assert "shards: 2" in out.getvalue()
    assert len(losses) == 3 and all(map(math.isfinite, losses))
    assert math.isfinite(float(out.getvalue().split("eval ")[1].split()[0]))


def test_launch_train_lgd_builds_a_sharded_pipeline():
    from repro_torch.launch.train import load_model, make_batches
    cfg, lm = load_model("phi4_mini_3_8b", False, "cpu")
    sampler, batches = make_batches(cfg, lm, lgd=True, batch=8, seq=16,
                                    corpus=64, device="cpu")
    assert batches is None and isinstance(sampler, ShardedLSHPipeline)
    assert sampler.n_shards == 1 and sampler.cfg.refresh_async
    b = sampler.next_batch()
    assert torch.equal(b["shard_ids"], torch.zeros(8, dtype=torch.int32))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = launch_train.main(["--arch", "phi4_mini_3_8b", "--lgd",
                                 "--steps", "2", "--seq", "16", "--corpus",
                                 "64", "--device", "cpu"])
    assert len(res["losses"]) == 2
    assert all(math.isfinite(v) for v in res["losses"])
