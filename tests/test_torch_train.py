"""The port's LM training slice against the JAX package, on the CPU.

phi4-mini SMOKE (f32, 2 layers, d 64, vocab 128); the reference's
``init_params`` carried into the port with ``convert``; tokens, weights
and the corpus from numpy seeds.  Tolerances:
  * the loss and ``pooled_features``: rtol 1e-5, atol 1e-6 (f32 through
    two layers, sums in another order); gradients rtol 1e-4, atol 1e-6
    (backward sums compound the order);
  * Adam: the golden-pin tolerance (rtol 1e-5, atol 1e-7); the in-place
    form is bitwise the functional one;
  * 5 trainer steps: losses rtol 1e-5, final params rtol 1e-4, atol
    1e-6 (Adam divides each gradient element by its own scale, so the
    gradients' 1e-6 differences reach the params at that level);
  * the pipeline: features rtol 1e-5, atol 1e-6; codes equal except
    where a projection is within 1e-4 of zero (``assert_codes_match``);
    batches drawn with the reference's draws: tokens and ids bitwise,
    weights rtol 1e-5;
  * the guard: params and optimiser state bitwise unchanged;
  * E[sum_i w_i f_i / m] = mean f over 40 index builds x 20 pipeline
    batches, within a 3-sigma band (statistical).
"""

import contextlib
import dataclasses
import io
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data as JD
import repro.optim as JO
import repro.optim.schedules as JSCH
import repro.train as JT
from _stats import mean_band
from _torch_parity import (ATOL, RTOL, assert_codes_match,
                           jax_sample_draws, n, t)
from repro import configs as jconfigs
from repro.core import hash_points as j_hash_points
from repro.models import init_params as j_init_params
from repro.models import loss as j_loss
from repro.models.lm import lm_head_query as j_lm_head_query
from repro.models.lm import pooled_features as j_pooled_features
from repro_torch import configs, convert
from repro_torch.core import hash_points
from repro_torch.data import (
    LSHPipelineConfig,
    LSHSampledPipeline,
    lm_head_query_fn,
    make_token_corpus,
    mean_pool_feature_fn,
    uniform_batches,
)
from repro_torch.launch import train as launch_train
from repro_torch.optim import Adam, apply_updates, schedules, update_in_place
from repro_torch.train import Trainer, TrainerConfig

ARCH = "phi4_mini_3_8b"
LOSS = dict(rtol=1e-5, atol=1e-6)
GRADS = dict(rtol=1e-4, atol=1e-6)
PARAMS = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def model():
    cfg = configs.get_smoke(ARCH)
    # jitted: one compile instead of many eager ones (the bits differ from
    # an eager init, which does not matter: both packages get the same)
    params = jax.jit(j_init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jconfigs.get_smoke(ARCH))
    return cfg, params


def _port(model):
    cfg, params = model
    return convert.lm_params_from_numpy(params, cfg, "cpu")


def _batch(cfg, seed, b=4, s=32):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": rows[:, :-1], "targets": rows[:, 1:],
            "loss_weights": rng.uniform(0.2, 3.0, b).astype(np.float32)}


def _tb(batch):
    return {k: t(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close_trees(got: dict, want, **tol):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_g) == len(flat_w)
    for path, g in flat_g:
        np.testing.assert_allclose(g, np.asarray(flat_w[path]), **tol,
                                   err_msg=jax.tree_util.keystr(path))


class TestModel:
    def test_weighted_loss_and_grads(self, model):
        cfg, params = model
        batch = _batch(cfg, 0)
        jcfg = jconfigs.get_smoke(ARCH)
        want_l, want_g = jax.jit(jax.value_and_grad(
            lambda p: j_loss(p, jcfg, _jb(batch))))(params)
        lm = _port(model)
        loss = lm.loss(_tb(batch))
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(want_l),
                                   **LOSS)
        grads = {k: p.grad for k, p in lm.named_parameters()}
        _close_trees(convert.lm_tree_to_numpy(grads, cfg), want_g, **GRADS)
        # 32 positions at loss_chunk 16: two checkpointed chunks; the
        # unweighted loss is the weights-free reference too
        unweighted = {k: v for k, v in batch.items() if k != "loss_weights"}
        np.testing.assert_allclose(
            float(lm.loss(_tb(unweighted)).detach()),
            float(jax.jit(j_loss, static_argnums=1)(params, jcfg,
                                                    _jb(unweighted))),
            **LOSS)

    def test_remat_does_not_change_grads(self, model):
        cfg, _ = model
        batch = _tb(_batch(cfg, 1))
        out = []
        for remat in (True, False):
            lm = _port(model)
            lm.cfg = cfg.with_(remat=remat)
            lm.loss(batch).backward()
            out.append([p.grad.clone() for p in lm.parameters()])
        for a, b in zip(*out):
            assert torch.equal(a, b)

    def test_pooled_features_and_query(self, model):
        cfg, params = model
        jcfg = jconfigs.get_smoke(ARCH)
        tokens = _batch(cfg, 2)["tokens"]
        lm = _port(model)
        np.testing.assert_allclose(
            n(lm.pooled_features({"tokens": t(tokens)})),
            np.asarray(j_pooled_features(params, jcfg,
                                         {"tokens": jnp.asarray(tokens)})),
            **LOSS)
        np.testing.assert_allclose(n(lm.lm_head_query()),
                                   np.asarray(j_lm_head_query(params)),
                                   **LOSS)


class TestAdam:
    def test_dict_adam_against_reference(self):
        rng = np.random.default_rng(3)
        params = {"a": rng.standard_normal((5, 7)).astype(np.float32),
                  "b": rng.standard_normal(11).astype(np.float32)}
        grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
                  for k, v in params.items()} for _ in range(3)]
        j_opt = JO.Adam(lr=JSCH.warmup_cosine(1e-2, 1, 10),
                        weight_decay=0.01)
        t_opt = Adam(lr=schedules.warmup_cosine(1e-2, 1, 10),
                     weight_decay=0.01)
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        tp = {k: t(v) for k, v in params.items()}
        js, ts = j_opt.init(jp), t_opt.init(tp)
        for g in grads:
            ju, js = j_opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                  js, jp)
            tu, ts = t_opt.update({k: t(v) for k, v in g.items()}, ts, tp)
            jp, tp = JO.apply_updates(jp, ju), apply_updates(tp, tu)
            for k in params:
                for got, want in ((tu[k], ju[k]), (ts.m[k], js.m[k]),
                                  (ts.v[k], js.v[k]), (tp[k], jp[k])):
                    np.testing.assert_allclose(n(got), np.asarray(want),
                                               rtol=RTOL, atol=ATOL)
        assert int(ts.step) == int(js.step) == 3

    def test_in_place_is_the_functional_step(self):
        rng = np.random.default_rng(4)
        p0 = {"w": t(rng.standard_normal((6, 3)).astype(np.float32)),
              "h": t(rng.standard_normal(8).astype(np.float32)).to(
                  torch.bfloat16)}
        g = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(
            5)).to(v.dtype) for k, v in p0.items()}
        opt = Adam(lr=3e-3)
        st = opt.init(p0)
        upd, st_f = opt.update(g, st, p0)
        want = apply_updates(p0, upd)
        p = {k: v.clone() for k, v in p0.items()}
        st_i = update_in_place(opt, p, g, opt.init(p0))
        for k in p0:
            assert p[k].dtype == p0[k].dtype
            assert torch.equal(p[k], want[k])
            assert torch.equal(st_i.m[k], st_f.m[k])
            assert st_i.m[k].dtype == torch.float32
        assert int(st_i.step) == 1


class TestTrainer:
    @pytest.mark.parametrize("accum", [1, 2])
    def test_five_steps_against_reference(self, model, accum):
        cfg, params = model
        jcfg = jconfigs.get_smoke(ARCH)
        batches = [_batch(cfg, 10 + i) for i in range(5)]
        jt = JT.Trainer(jcfg, params,
                        JO.Adam(lr=JSCH.warmup_cosine(1e-2, 2, 5)),
                        iter([_jb(b) for b in batches]),
                        JT.TrainerConfig(log_every=1, grad_accum=accum,
                                         donate=False),
                        resume=False)
        want = jt.run(5)["losses"]
        lm = _port(model)
        tt = Trainer(cfg, lm, Adam(lr=schedules.warmup_cosine(1e-2, 2, 5)),
                     iter([_tb(b) for b in batches]),
                     TrainerConfig(log_every=1, grad_accum=accum))
        got = tt.run(5)["losses"]
        np.testing.assert_allclose(got, want, **LOSS)
        _close_trees(convert.lm_params_to_numpy(lm), jt.params, **PARAMS)
        assert [m["step"] for m in tt.metrics_history] == [1, 2, 3, 4, 5]
        np.testing.assert_allclose(
            [m["grad_norm"] for m in tt.metrics_history],
            [m["grad_norm"] for m in jt.metrics_history], rtol=1e-4)
        st = convert.adam_state_to_numpy(tt.opt_state, cfg)
        assert int(st["step"]) == 5
        _close_trees(st["m"], jt.opt_state.m, **PARAMS)
        back = convert.adam_state_from_numpy(jt.opt_state, lm)
        assert set(back.v) == set(tt.opt_state.v)
        for k, v in back.v.items():
            assert v.dtype == torch.float32
            np.testing.assert_allclose(n(v), n(tt.opt_state.v[k]), **PARAMS)

    def test_nonfinite_step_changes_nothing(self, model):
        cfg, _ = model
        lm = _port(model)
        good, bad = _tb(_batch(cfg, 20)), _tb(_batch(cfg, 21))
        bad["loss_weights"][1] = float("nan")
        tr = Trainer(cfg, lm, Adam(lr=1e-2), iter([good, bad, good]))
        tr.run(1)
        before = [p.detach().clone() for p in lm.parameters()]
        state = jax.tree_util.tree_map(torch.clone, tuple(tr.opt_state))
        loss, _, ok = tr.train_step(bad)
        assert ok is False and not math.isfinite(float(loss))
        for a, b in zip(before, lm.parameters()):
            assert torch.equal(a, b)
        for a, b in zip(jax.tree_util.tree_leaves(state),
                        jax.tree_util.tree_leaves(tuple(tr.opt_state))):
            assert torch.equal(a, b)
        assert all(p.grad is None for p in lm.parameters())

    def test_guard_counts_skips_in_run(self, model):
        cfg, _ = model
        good, bad = _tb(_batch(cfg, 22)), _tb(_batch(cfg, 23))
        bad["loss_weights"][0] = float("inf") * 0
        tr = Trainer(cfg, _port(model), Adam(lr=1e-2), iter([good, bad,
                                                               good]))
        losses = tr.run(3)["losses"]
        assert tr.skipped_steps == 1 and tr.step == 3
        assert math.isfinite(losses[2]) and not math.isfinite(losses[1])
        assert int(tr.opt_state.step) == 2

    def test_not_ported_knobs_raise(self, model, tmp_path):
        """The three knobs that raised before the training stack was
        ported now construct and act: a checkpoint on disk, a compressed
        step's residual, the hook's calls."""
        cfg, _ = model
        calls = []
        tcfg = TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=2,
                             grad_compress=True,
                             step_hook=lambda tr: calls.append(tr.step))
        tr = Trainer(cfg, _port(model), Adam(lr=1e-2),
                     iter([_tb(_batch(cfg, 30 + i)) for i in range(2)]),
                     tcfg)
        assert tr.run(2)["losses"] and calls == [1, 2]
        tr.finalize()
        assert sorted(os.listdir(tmp_path)) == ["step_00000002"]
        assert any(bool(r.abs().sum()) for r in tr._ef_residual.values())


class TestData:
    def test_corpus_and_uniform_batches_bitwise(self):
        want = JD.make_token_corpus(0, 64, 16, 128)
        got = make_token_corpus(0, 64, 16, 128)
        np.testing.assert_array_equal(got.tokens, want.tokens)
        np.testing.assert_array_equal(got.hard_mask, want.hard_mask)
        jb, tb = (JD.uniform_batches(want, 4, seed=1),
                  uniform_batches(got, 4, seed=1, device="cpu"))
        for _ in range(3):
            b_j, b_t = next(jb), next(tb)
            for k in ("tokens", "targets", "example_ids"):
                np.testing.assert_array_equal(n(b_t[k]), np.asarray(b_j[k]))


def _pipelines(model, n_rows=96, seq=16, refresh_every=3, feature_batch=32,
               family="srp"):
    cfg, params = model
    jcfg = jconfigs.get_smoke(ARCH)
    tokens = make_token_corpus(0, n_rows, seq, cfg.vocab).tokens
    ref = JD.LSHSampledPipeline(
        jax.random.PRNGKey(2), tokens, JD.mean_pool_feature_fn(jcfg),
        JD.lm_head_query_fn(),
        JD.LSHPipelineConfig(k=4, l=8, minibatch=8, family=family,
                             refresh_every=refresh_every, use_pallas=False),
        params=params)
    return ref, _port_pipeline(model, tokens, refresh_every, feature_batch,
                               family=family,
                               projections=t(ref.index.projections))


def _port_pipeline(model, tokens, refresh_every, feature_batch=32,
                   family="srp", **kw):
    cfg = model[0]
    return LSHSampledPipeline(
        2, tokens, mean_pool_feature_fn(cfg), lm_head_query_fn(),
        LSHPipelineConfig(k=4, l=8, minibatch=8, family=family,
                          refresh_every=refresh_every),
        feature_batch=feature_batch, params=_port(model), device="cpu", **kw)


class TestPipeline:
    def test_features_codes_and_batches(self, model):
        ref, got = _pipelines(model)
        np.testing.assert_allclose(n(got.features), np.asarray(ref.features),
                                   **LOSS)
        proj = np.asarray(ref.features) @ np.asarray(ref.index.projections)
        flips = assert_codes_match(
            hash_points(got.features, got.index.projections, got.lsh).T,
            np.asarray(j_hash_points(ref.features, ref.index.projections,
                                     ref.lsh)).T, proj, ref.lsh.k)
        if flips == 0:
            np.testing.assert_array_equal(
                n(got.index.sorted_codes),
                np.asarray(ref.index.sorted_codes).astype(np.int64))
            np.testing.assert_array_equal(n(got.index.order),
                                          np.asarray(ref.index.order))
        # five batches across the refresh at step 3, each with the
        # reference's draws: fold_in(fold_in(key, _SALT_STEP), step)
        stream = jax.random.fold_in(jax.random.PRNGKey(2), 0x057E9)
        for step in range(5):
            draws = jax_sample_draws(jax.random.fold_in(stream, step), 8,
                                     max(2 * got.lsh.l, 8), got.lsh.l,
                                     got.n)
            bj, bt = ref.next_batch(), got.next_batch(draws=draws)
            for k in ("tokens", "targets", "example_ids"):
                np.testing.assert_array_equal(
                    n(bt[k]).astype(np.int64),
                    np.asarray(bj[k]).astype(np.int64), err_msg=k)
            np.testing.assert_allclose(n(bt["loss_weights"]),
                                       np.asarray(bj["loss_weights"]),
                                       rtol=RTOL)
        assert got._refresh_count == 1
        # one probe launch and one gather for C = 3 chains
        queries = np.random.default_rng(6).standard_normal(
            (3, got.features.shape[1])).astype(np.float32)
        draws = jax_sample_draws(jax.random.fold_in(stream, 5), 8,
                                 max(2 * got.lsh.l, 8), got.lsh.l, got.n,
                                 batch=3)
        for bj, bt in zip(ref.next_batch_multi(jnp.asarray(queries)),
                          got.next_batch_multi(t(queries), draws=draws)):
            np.testing.assert_array_equal(
                n(bt["tokens"]), np.asarray(bj["tokens"]))
            np.testing.assert_allclose(n(bt["loss_weights"]),
                                       np.asarray(bj["loss_weights"]),
                                       rtol=RTOL)
        st = got.sampler_stats()
        assert st["draws"] == 64 and 0.0 <= st["fallback_rate"] <= 1.0

    def test_failed_refresh_retries_then_keeps_the_index(self, model):
        pipe = _port_pipeline(
            model, make_token_corpus(0, 64, 16, model[0].vocab).tokens, 0)
        pipe.cfg.refresh_backoff = 0.0
        feature_fn, calls = pipe.feature_fn, []

        def flaky(params, tokens):
            calls.append(1)
            if len(calls) <= 2:
                raise RuntimeError("injected")
            return feature_fn(params, tokens)

        pipe.feature_fn = flaky
        assert pipe.refresh()                       # third attempt succeeds
        index = pipe.index

        def down(params, tokens):
            raise RuntimeError("down")

        pipe.feature_fn = down
        assert not pipe.refresh()                   # 1 + 2 retries fail
        assert pipe.index is index and pipe._refresh_count == 2

    def test_mips_features_and_batch(self, model):
        """The asymmetric family: un-normalised features augmented under
        their max norm, as the reference's; the batch draws the same
        rows with the reference's draws."""
        ref, got = _pipelines(model, refresh_every=0, family="mips")
        assert got.features.shape[1] == model[0].d_model + 1
        np.testing.assert_allclose(n(got.features), np.asarray(ref.features),
                                   **LOSS)
        stream = jax.random.fold_in(jax.random.PRNGKey(2), 0x057E9)
        draws = jax_sample_draws(jax.random.fold_in(stream, 0), 8,
                                 max(2 * got.lsh.l, 8), got.lsh.l, got.n)
        bj, bt = ref.next_batch(), got.next_batch(draws=draws)
        np.testing.assert_array_equal(n(bt["tokens"]), np.asarray(bj["tokens"]))
        np.testing.assert_allclose(n(bt["loss_weights"]),
                                   np.asarray(bj["loss_weights"]), rtol=RTOL)

    def test_same_step_same_batch(self, model):
        """The same seed draws the same projections and batches, whatever
        the embed chunking."""
        tokens = make_token_corpus(0, 96, 16, model[0].vocab).tokens
        a = _port_pipeline(model, tokens, 0)
        b = _port_pipeline(model, tokens, 0, feature_batch=96)
        assert torch.equal(a.index.projections, b.index.projections)
        for _ in range(3):
            ba, bb = a.next_batch(), b.next_batch()
            for k in ba:
                assert torch.equal(ba[k], bb[k])

    def test_not_ported_config_raises(self):
        """The streaming, delta, async, watchdog and health knobs are
        ported: each config is the reference's, field for field, and the
        reference's invalid values raise as there.  What stays unported,
        the legacy closure hooks, raises."""
        from repro_torch.data.health import HealthConfig
        for kw in ({"refresh_mode": "delta"}, {"refresh_async": True},
                   {"window": 8}, {"streaming": True},
                   {"refresh_timeout": 1.0},
                   {"health": HealthConfig(recover_after=5)}):
            got = dataclasses.asdict(LSHPipelineConfig(**kw))
            want = dataclasses.asdict(JD.LSHPipelineConfig(**{
                k: (JD.HealthConfig(**dataclasses.asdict(v))
                    if k == "health" else v) for k, v in kw.items()}))
            assert got == want
        for kw in ({"window": 0}, {"streaming": True, "min_capacity": 3},
                   {"streaming": True, "k": 32},
                   {"refresh_mode": "incremental"}):
            with pytest.raises(ValueError):
                LSHPipelineConfig(**kw)
            with pytest.raises(ValueError):
                JD.LSHPipelineConfig(**kw)
        with pytest.raises(NotImplementedError, match="legacy closure"):
            LSHSampledPipeline(0, np.zeros((4, 3), np.int32), None, None,
                               LSHPipelineConfig(), device="cpu")

    @pytest.mark.statistical
    def test_weighted_estimate_is_unbiased(self, model):
        """E[(1/m) sum_i w_i f_{id_i}] = mean_N f with raw 1/(p N)
        weights, the expectation over index builds (seeds) and draws —
        Algorithm 1's p averages over the hash functions, so one fixed
        index is not unbiased.  The calibrated regime of the reference's
        identity tests: K=3, L=24 (buckets populated, no fallbacks).
        Measured at these seeds: per-build sd 0.52 over 40 builds x 20
        batches; the band is 3 sigma."""
        cfg, _ = model
        lm = _port(model)
        tokens = make_token_corpus(1, 128, 16, cfg.vocab).tokens
        f = 1.0 + torch.arange(128, dtype=torch.float64) % 5
        ests, fallback = [], 0.0
        for seed in range(40):
            pipe = LSHSampledPipeline(
                seed, tokens, mean_pool_feature_fn(cfg), lm_head_query_fn(),
                LSHPipelineConfig(k=3, l=24, minibatch=8, refresh_every=0,
                                  normalize_weights=False),
                params=lm, device="cpu")
            ests.append(torch.stack([
                (b["loss_weights"].double() * f[b["example_ids"]]).mean()
                for b in (pipe.next_batch() for _ in range(20))]).mean())
            fallback = max(fallback, pipe.sampler_stats()["fallback_rate"])
        assert fallback < 0.05                                # regime guard
        ests = torch.stack(ests)
        assert abs(float(ests.mean()) - float(f.mean())) <= mean_band(
            float(ests.std()), len(ests))


class TestLauncher:
    def test_lgd_smoke_run(self):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            res = launch_train.main(["--arch", ARCH, "--lgd", "--steps", "3",
                                     "--device", "cpu"])
        assert len(res["losses"]) == 3
        assert all(math.isfinite(v) for v in res["losses"])
        assert "phi4-mini-smoke" in out.getvalue()

    def test_feature_batch_from_memory(self):
        assert launch_train.feature_batch_for(configs.get(ARCH), 512) == 64
        assert launch_train.feature_batch_for(configs.get_smoke(ARCH),
                                              64) == 512

    def test_ckpt_resumes_from_the_newest_checkpoint(self, tmp_path):
        """``--ckpt DIR`` resumes from DIR's newest valid checkpoint (one
        written here at step 2 by the launcher's own trainer) and trains
        ``--steps`` more.  (The reference launcher cannot be run beside
        it: it raises under JAX 0.9, ROADMAP.md queue 3.)"""
        cfg, lm = launch_train.load_model(ARCH, False, "cpu")
        _, batches = launch_train.make_batches(
            cfg, lm, lgd=False, batch=8, seq=64, corpus=2048, device="cpu")
        tr = launch_train.make_trainer(
            cfg, lm, steps=2, lr=1e-3, batches=batches,
            tcfg=TrainerConfig(ckpt_dir=str(tmp_path)))
        tr.run(2)
        tr.save()
        tr.finalize()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            res = launch_train.main(["--arch", ARCH, "--steps", "2",
                                     "--device", "cpu", "--ckpt",
                                     str(tmp_path)])
        assert f"resumed at step 2 from {tmp_path}" in out.getvalue()
        assert len(res["losses"]) == 2
        assert all(math.isfinite(v) for v in res["losses"])

    def test_mesh_flags_raise(self):
        """The production mesh is built, not refused: without its 256 (or
        512) ranks, a process group that cannot hold it raises (the dry
        run covers those meshes: tests/test_torch_dryrun.py)."""
        with pytest.raises(RuntimeError, match="needs 256 ranks"):
            launch_train.main(["--arch", ARCH, "--production-mesh",
                               "--device", "cpu"])
        with pytest.raises(RuntimeError, match="needs 512 ranks"):
            launch_train.main(["--arch", ARCH, "--production-mesh",
                               "--multi-pod", "--device", "cpu"])
