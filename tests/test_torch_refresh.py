"""The port's delta and async refresh, restore and degradation ladder
against the JAX package, on the CPU.

* Delta refresh: against ``repro.data.LSHSampledPipeline`` in delta mode
  on the same projections, with the reference's draws and drift masks
  injected (``draws=`` / ``drift=``) and the embedding changed between
  refreshes: tokens and ids bitwise, weights rtol 1e-5, and after every
  refresh ``sorted_codes`` / ``order`` bitwise (integer embeddings: the
  features are exact in both, and no projection is within 1e-4 of zero
  at these seeds).  An all-dirty delta is bitwise the full refresh.
* The reference's refresh contracts, each after the test it names in
  tests/test_sharded_lgd.py (one pipeline where it shards): delta
  equals full when features are static, the dirty mask tracks visits,
  async delta is deterministic, async equals sync (bitwise, static
  features), a restored delta pipeline replays the uninterrupted run.
* The in-place weights contract of the async refresh: weights changed in
  place right after a launch (behind ``before_param_update``, as the
  trainer does) leave the refreshed features bitwise those of the
  launch-time weights.
* The ladder: ``HealthMonitor`` against ``repro.data.HealthMonitor`` on
  the same event sequences (tests/test_chaos.py:297-356), transitions
  and summaries equal; and the three chaos scenarios of
  tests/test_chaos.py:106-172 through the port's ``Trainer`` with
  ``repro_torch.testing.RefreshRaise`` (the watchdog case with a local
  hang that the test releases).
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.data as JD
from _torch_parity import RTOL, assert_codes_match, jax_sample_draws, n, t
from repro_torch.convert import codes_to_numpy
from repro_torch.core import hash_points
from repro_torch.data import (
    LSHPipelineConfig,
    LSHSampledPipeline,
    lm_head_query_fn,
    make_token_corpus,
    mean_pool_feature_fn,
)
from repro_torch.data.health import (
    HEALTHY,
    STALE_INDEX,
    UNIFORM_FALLBACK,
    HealthConfig,
    HealthMonitor,
)
from repro_torch.models import LM, ModelConfig
from repro_torch.optim import Adam
from repro_torch.testing import FaultError, RefreshRaise
from repro_torch.train import Trainer, TrainerConfig

VOCAB, DIM, SEQ = 50, 16, 9
RNG = np.random.default_rng(1)
# integer embeddings: the features (sums, norms) are exact in both packages
EMBEDS = [RNG.integers(-4, 5, (VOCAB, DIM)).astype(np.float32)
          for _ in range(3)]
QUERY = np.random.default_rng(2).standard_normal(DIM).astype(np.float32)
SALT_STEP, SALT_REFRESH = 0x057E9, 0x0F5E5


def _tparams(i=0):
    return {"embed": torch.from_numpy(EMBEDS[i].copy()),
            "q": torch.from_numpy(QUERY.copy())}


def _jparams(i=0):
    return {"embed": jnp.asarray(EMBEDS[i]), "q": jnp.asarray(QUERY)}


def t_feature_fn(params, chunk):
    return params["embed"][chunk].sum(1)


def j_feature_fn(params, chunk):
    return jnp.sum(params["embed"][chunk], axis=1)


def _tokens(n_rows=128, seed=2):
    return np.random.default_rng(seed).integers(
        0, VOCAB, (n_rows, SEQ)).astype(np.int32)


def _pipe(tokens=None, seed=7, params=None, **kw):
    for k, v in dict(k=4, l=8, minibatch=16, refresh_every=6).items():
        kw.setdefault(k, v)
    return LSHSampledPipeline(
        seed, _tokens() if tokens is None else tokens, t_feature_fn,
        lambda p: p["q"], LSHPipelineConfig(**kw),
        params=_tparams() if params is None else params, device="cpu")


def _same_batches(a, b, steps):
    for _ in range(steps):
        ba, bb = a.next_batch(), b.next_batch()
        for k in ba:
            assert torch.equal(ba[k], bb[k]), k


def _assert_index_equal(got, want):
    np.testing.assert_array_equal(codes_to_numpy(got.sorted_codes),
                                  np.asarray(want.sorted_codes))
    np.testing.assert_array_equal(n(got.order), np.asarray(want.order))


# -- the delta refresh against the reference -----------------------------------

def _ref_drift(key, frac):
    """The reference's drift draw of refresh r, as the port's hook."""
    stream = jax.random.fold_in(key, SALT_REFRESH)

    def drift(r, cap):
        kd = jax.random.fold_in(jax.random.fold_in(stream, r), 1)
        return t(jax.random.bernoulli(kd, frac, (cap,)))
    return drift


@pytest.mark.parametrize("asynchronous", [False, True])
def test_delta_refresh_matches_the_reference(asynchronous):
    """12 steps, a delta refresh every 4, the embedding switched between
    refreshes: the dirty rows (from the same draws) plus the same drift
    draw are re-embedded and merged in both packages."""
    key = jax.random.PRNGKey(15)
    tokens = _tokens(120, seed=9)
    kw = dict(k=4, l=8, minibatch=8, refresh_every=4, refresh_mode="delta",
              drift_frac=0.2, refresh_async=asynchronous, refresh_lead=2)
    ref = JD.LSHSampledPipeline(key, tokens, j_feature_fn, lambda p: p["q"],
                                JD.LSHPipelineConfig(use_pallas=False, **kw),
                                params=_jparams())
    got = LSHSampledPipeline(
        15, tokens, t_feature_fn, lambda p: p["q"], LSHPipelineConfig(**kw),
        params=_tparams(), device="cpu",
        projections=t(ref.index.projections), drift=_ref_drift(key, 0.2))
    stream = jax.random.fold_in(key, SALT_STEP)
    for step in range(12):
        if step in (1, 6):                   # the model moved
            i = 1 + (step == 6)
            ref.set_params(_jparams(i))
            got.set_params(_tparams(i))
        draws = jax_sample_draws(jax.random.fold_in(stream, step), 8,
                                 max(2 * got.lsh.l, 8), got.lsh.l, got.n)
        bj, bt = ref.next_batch(), got.next_batch(draws=draws)
        for k in ("tokens", "example_ids"):
            np.testing.assert_array_equal(
                n(bt[k]).astype(np.int64),
                np.asarray(bj[k]).astype(np.int64), err_msg=k)
        np.testing.assert_allclose(n(bt["loss_weights"]),
                                   np.asarray(bj["loss_weights"]), rtol=RTOL)
        if step in (4, 8):
            np.testing.assert_array_equal(n(got.features),
                                          np.asarray(ref.features))
            _assert_index_equal(got.index, ref.index)
    got.finalize()
    ref.finalize()
    assert got._refresh_count == ref._refresh_count == 2
    rows = [r["rows"] for r in got.refresh_records()]
    assert all(r is not None and r % 64 == 0 for r in rows), rows


def test_all_dirty_delta_bitwise_equals_full_refresh():
    """refresh(full=False) with every row dirty gives bitwise the index
    and features of refresh(full=True), and the reference's."""
    tokens = _tokens(128, seed=8)
    kw = dict(k=4, l=8, minibatch=8, refresh_every=0, refresh_mode="delta",
              drift_frac=0.0)
    ref = JD.LSHSampledPipeline(jax.random.PRNGKey(4), tokens, j_feature_fn,
                                lambda p: p["q"],
                                JD.LSHPipelineConfig(use_pallas=False, **kw),
                                params=_jparams())
    proj = t(ref.index.projections)
    a, b = (LSHSampledPipeline(4, tokens, t_feature_fn, lambda p: p["q"],
                               LSHPipelineConfig(**kw), params=_tparams(),
                               device="cpu", projections=proj)
            for _ in range(2))
    for p in (a, b, ref):
        p.set_params(_tparams(1) if p is not ref else _jparams(1))
    a._dirty = torch.ones(a.n, dtype=torch.bool)
    a.refresh(full=False)
    b.refresh(full=True)
    ref.refresh(full=True)
    assert a._refresh_count == b._refresh_count == 1
    assert torch.equal(a.index.order, b.index.order)
    assert torch.equal(a.index.sorted_codes, b.index.sorted_codes)
    assert torch.equal(a.features, b.features)
    assert assert_codes_match(
        hash_points(b.features, b.index.projections, b.lsh).T,
        np.asarray(J.hash_points(ref.features, ref.index.projections,
                                 ref.lsh)).T,
        np.asarray(ref.features) @ np.asarray(ref.index.projections), 4) == 0
    _assert_index_equal(b.index, ref.index)
    assert [r["rows"] for r in a.refresh_records()] == [128]


# -- the reference's refresh contracts (tests/test_sharded_lgd.py) ------------

def test_delta_mode_draws_match_full_mode_when_features_static():
    full = _pipe(refresh_every=5)
    delta = _pipe(refresh_every=5, refresh_mode="delta", drift_frac=0.25)
    for _ in range(17):
        bf, bd = full.next_batch(), delta.next_batch()
        assert torch.equal(bf["example_ids"], bd["example_ids"])
        assert torch.equal(bf["loss_weights"], bd["loss_weights"])
    assert delta._refresh_count == 3


def test_dirty_mask_tracks_visits_and_resets():
    pipe = _pipe(_tokens(64), refresh_every=100, refresh_mode="delta")
    seen = set()
    for _ in range(3):
        seen |= set(pipe.next_batch()["example_ids"].tolist())
    assert set(torch.nonzero(pipe._dirty).flatten().tolist()) == seen
    pipe.refresh(full=False)
    assert not pipe._dirty.any()
    # a full-mode pipeline does not track visits
    full = _pipe(_tokens(64), refresh_every=100)
    full.next_batch()
    assert not full._dirty.any()


def test_async_delta_refresh_is_deterministic():
    """Two async delta pipelines stay bitwise in lock-step through
    overlapped refreshes while the model moves."""
    a, b = (_pipe(refresh_every=4, refresh_mode="delta", refresh_async=True,
                  refresh_lead=2, drift_frac=0.2) for _ in range(2))
    for step in range(14):
        if step % 3 == 1:
            for p in (a, b):
                p.set_params(_tparams(step % 2 + 1))
        _same_batches(a, b, 1)
    a.finalize()
    b.finalize()
    assert a._refresh_count == 3


def test_async_refresh_bit_matches_sync():
    sync = _pipe(refresh_every=6)
    asyn = _pipe(refresh_every=6, refresh_async=True, refresh_lead=2)
    _same_batches(sync, asyn, 20)
    assert asyn._refresh_count == 3
    asyn.finalize()
    assert all(r["async"] and r["ok"] for r in asyn.refresh_records())


def test_restored_delta_pipeline_replays_uninterrupted_run():
    """A pipeline built fresh and restored at step 9 (canonical build,
    empty dirty mask) draws the uninterrupted delta-mode run's batches,
    features static: every delta refresh re-hashes to the same codes."""
    tokens = _tokens(120, seed=9)
    kw = dict(refresh_every=4, refresh_mode="delta", drift_frac=0.3,
              minibatch=8)
    live = _pipe(tokens, seed=15, **kw)
    for _ in range(9):
        live.next_batch()
    restored = _pipe(tokens, seed=15, **kw)
    restored.restore_at(9, rebuild=False)
    assert restored._refresh_count == 2
    _same_batches(live, restored, 8)


def test_two_restores_are_bitwise_equal():
    """restore_at(t) twice, after the model moved: the same canonical
    index and the same batches."""
    pipe = _pipe(refresh_every=4, refresh_mode="delta", refresh_async=True)
    for _ in range(6):
        pipe.next_batch()
    pipe.set_params(_tparams(2))
    pipe.restore_at(5)
    first = (pipe.index.sorted_codes.clone(), pipe.index.order.clone(),
             [pipe.next_batch() for _ in range(5)])
    pipe.restore_at(5)
    assert torch.equal(first[0], pipe.index.sorted_codes)
    assert torch.equal(first[1], pipe.index.order)
    for want in first[2]:
        got = pipe.next_batch()
        for k in want:
            assert torch.equal(got[k], want[k])
    pipe.finalize()


def test_async_features_are_the_launch_time_weights():
    """The weights change IN PLACE right after the launch (behind
    ``before_param_update``, as the trainer's optimiser step), while the
    worker embeds slowly: the swapped-in features are bitwise those of
    the launch-time weights."""
    params = _tparams()

    def slow(p, chunk):
        time.sleep(0.02)
        return p["embed"][chunk].sum(1)

    pipe = LSHSampledPipeline(
        3, _tokens(96), slow, lambda p: p["q"],
        LSHPipelineConfig(k=4, l=8, minibatch=8, refresh_every=3,
                          refresh_async=True, refresh_lead=1),
        feature_batch=8, params=params, device="cpu")
    for _ in range(3):                       # the launch is at step 2
        pipe.next_batch()
    assert pipe._flight is not None
    launch_time = {"embed": params["embed"].clone(), "q": params["q"]}
    pipe.before_param_update()
    params["embed"].mul_(3).add_(1)          # the in-place update
    pipe.next_batch()                        # step 3: the swap
    pipe.feature_fn = t_feature_fn
    want, _ = pipe._compute_features_scaled(launch_time)
    assert torch.equal(pipe.features, want)
    moved, _ = pipe._compute_features_scaled(params)
    assert not torch.equal(pipe.features, moved)
    assert pipe.refresh_records()[0]["wait_s"] > 0.0


# -- the degradation ladder ------------------------------------------------------

SEQUENCES = {
    "staleness_bound": (dict(max_stale_refreshes=2), [
        ("note_refresh_failure", 10), ("note_refresh_failure", 20),
        ("note_refresh_failure", 30)]),
    "refresh_success_recovers": ({}, [
        ("note_refresh_failure", 10), ("note_refresh_success", 20)]),
    "fallback_spike_needs_consecutive_strikes": (
        dict(fallback_spike=0.9, fallback_strikes=3), [
            ("note_fallback_rate", 10, 0.95), ("note_fallback_rate", 20, 0.95),
            ("note_fallback_rate", 30, 0.5), ("note_fallback_rate", 40, 0.95),
            ("note_fallback_rate", 50, 0.95), ("note_fallback_rate", 60, 1.0)]),
    "nonfinite_loss_streak": (dict(nonfinite_strikes=2), [
        ("note_loss", 1, False), ("note_loss", 2, True),
        ("note_loss", 3, False), ("note_loss", 4, False)]),
    "recovery_cadence": (dict(max_stale_refreshes=0, recover_after=5), [
        ("note_refresh_failure", 7), ("should_attempt_recovery", 7),
        ("should_attempt_recovery", 11), ("should_attempt_recovery", 12),
        ("note_recovered", 12), ("note_refresh_failure", 20),
        ("note_fallback_rate", 21, 0.99)]),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_health_monitor_matches_the_reference(name):
    """The port's monitor and the reference's on the same events: every
    answer, state, transition and summary equal."""
    cfg, events = SEQUENCES[name]
    got, want = (HealthMonitor(HealthConfig(**cfg)),
                 JD.HealthMonitor(JD.HealthConfig(**cfg)))
    for method, *args in events:
        assert getattr(got, method)(*args) == getattr(want, method)(*args)
        assert (got.state, got.degraded) == (want.state, want.degraded)
    assert got.summary() == want.summary()
    assert got.transitions and got.transitions == want.transitions


class Hang(RefreshRaise):
    """Hang the first ``cycles`` refresh cycles' attempts until
    ``release`` is set (at most ``seconds``): past the watchdog however
    slow the steps run.  (``RefreshHang`` sleeps a fixed time; this one
    lets the test end the abandoned worker.)"""

    def __init__(self, cycles, seconds):
        super().__init__(cycles)
        self.seconds = seconds
        self.release = threading.Event()

    def fire(self, event, **info):
        try:
            super().fire(event, **info)
        except FaultError:
            self.release.wait(self.seconds)


STEPS = 50


def _chaos(fault, **pipe_kw):
    """A tiny LM trained STEPS steps on an async LGD pipeline with one
    injected fault; returns (trainer, losses, states in order)."""
    cfg = ModelConfig(name="chaos", n_layers=2, d_model=32, n_heads=4,
                      n_kv_heads=2, d_ff=64, vocab=64, chunk=16,
                      loss_chunk=16, dtype="float32", rope_theta=10000.0)
    lm = LM.init(cfg, seed=0, device="cpu")
    pipe_kw.setdefault("health", HealthConfig(fallback_spike=1.1))
    sampler = LSHSampledPipeline(
        12, make_token_corpus(11, 256, 16, cfg.vocab, hard_frac=0.15).tokens,
        mean_pool_feature_fn(cfg), lm_head_query_fn(),
        LSHPipelineConfig(k=5, l=10, minibatch=16, refresh_every=10,
                          refresh_async=True, refresh_backoff=0.0,
                          **pipe_kw), params=lm, device="cpu")
    sampler.set_fault_injector(fault)
    tr = Trainer(cfg, lm, Adam(lr=1e-2), tcfg=TrainerConfig(log_every=10),
                 sampler=sampler)
    losses = tr.run(STEPS)["losses"]
    tr.finalize()
    assert len(losses) == STEPS and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    trans = [e["health_transitions"] for e in tr.metrics_history][-1]
    return tr, [t_[2] for t_ in trans]


def test_three_failed_refresh_cycles_survive_as_stale_index():
    fault = RefreshRaise(cycles=3)
    tr, states = _chaos(fault, refresh_retries=1)
    assert fault.fired == 3 * 2          # 3 cycles x (1 + 1 retry)
    assert states == [STALE_INDEX, HEALTHY]
    assert tr.sampler.health_state() == HEALTHY
    assert tr.sampler.health_summary()["refresh_failures"] == 3


def test_persistent_failure_degrades_to_uniform_and_recovers():
    tr, states = _chaos(RefreshRaise(cycles=2), refresh_retries=0,
                        health=HealthConfig(max_stale_refreshes=1,
                                            recover_after=8,
                                            fallback_spike=1.1))
    assert states == [STALE_INDEX, UNIFORM_FALLBACK, HEALTHY]
    assert tr.sampler.health_summary()["recoveries"] >= 1


def test_hung_worker_is_abandoned_by_watchdog():
    fault = Hang(cycles=1, seconds=60.0)
    try:
        tr, states = _chaos(fault, refresh_retries=0, refresh_timeout=0.25)
    finally:
        fault.release.set()              # let the abandoned worker end
    assert fault.fired >= 1
    assert states == [STALE_INDEX, HEALTHY]
    assert tr.sampler.health_state() == HEALTHY
