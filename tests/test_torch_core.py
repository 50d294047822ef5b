"""Parity of the port's core modules with the JAX package's.

Families, SimHash helpers, the sorted-code index, Algorithm 1 and the
estimator run in both packages on the same numpy inputs, in one
process.  Floats match at the reference's golden-pin tolerance
(rtol=1e-5, atol=1e-7); integer outputs bitwise.  Index builds use the
reference's projections (injected through ``IndexMutation``), and the
samplers the reference's draws rebuilt from the same key
(``_torch_parity.jax_sample_draws``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.estimator as JE
import repro.core.families as JF
import repro.core.lgd as JL
import repro.core.sampler as JS
import repro_torch.core as T
import repro_torch.core.estimator as TE
import repro_torch.core.families as TF
import repro_torch.core.lgd as TL
import repro_torch.core.sampler as TS
from _torch_parity import (
    ATOL, RTOL, assert_codes_match, assert_results_match, jax_drain_draws,
    jax_sample_draws, n, t)
from repro_torch.convert import codes_from_numpy, codes_to_numpy

FAMILIES = ("quadratic", "dense", "sparse", "mips")


def _close(got, want):
    np.testing.assert_allclose(n(got), n(want), rtol=RTOL, atol=ATOL)


def _data(seed, n_pts=400, d=10):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n_pts, d)) * rng.uniform(0.5, 2.0, (n_pts, 1))
         + np.linspace(0.0, 1.0, d)).astype(np.float32)
    y = (x @ rng.standard_normal(d) + rng.standard_normal(n_pts)).astype(
        np.float32)
    return x, y


# ---------------------------------------------------------------------------
# families
# ---------------------------------------------------------------------------

class TestFamilies:
    def test_registry(self):
        assert TF.get_family("srp") is TF.get_family("dense")
        for name in ("dense", "sparse", "quadratic", "mips", "mips_banded"):
            jf, tf = JF.get_family(name), TF.get_family(name)
            assert (tf.proj_kind, tf.asymmetric, tf.aug_dim(7),
                    tf.code_width(5), tf.num_bands()) == (
                jf.proj_kind, jf.asymmetric, jf.aug_dim(7),
                jf.code_width(5), jf.num_bands())
        banded = TF.get_family("mips_banded")
        assert (banded.n_bands, banded.band_bits()) == (
            JF.get_family("mips_banded").n_bands,
            JF.get_family("mips_banded").band_bits())
        assert TF.family_names() == JF.family_names()
        with pytest.raises(ValueError, match="unknown LSH family"):
            T.LSHParams(k=4, l=2, dim=8, family="minhash")

    @pytest.mark.parametrize("name", FAMILIES)
    def test_collision_and_probe_class_probs(self, name):
        rng = np.random.default_rng(5)
        x = rng.standard_normal((50, 9)).astype(np.float32)
        q = rng.standard_normal(9).astype(np.float32)
        jf, tf = JF.get_family(name), TF.get_family(name)
        xa_j, qa_j = jf.augment_data(x), jf.augment_query(q)
        xa_t, qa_t = tf.augment_data(t(x)), tf.augment_query(t(q))
        _close(xa_t, xa_j)
        _close(qa_t, qa_j)
        cp_j = jf.collision_prob(xa_j, qa_j)
        cp_t = tf.collision_prob(xa_t, qa_t)
        _close(cp_t, cp_j)
        rs = np.array([0, 1, 1, 2], np.float32)
        _close(tf.probe_class_probs(cp_t[:, None], 5, t(rs)),
               jf.probe_class_probs(cp_j[:, None], 5, jnp.asarray(rs)))

    def test_mips_scale_replay(self):
        x, _ = _data(6, 30, 5)
        tf, jf = TF.get_family("mips"), JF.get_family("mips")
        _close(tf.data_scale(t(x)), jf.data_scale(x))
        _close(tf.augment_data(t(x[:4]), scale=tf.data_scale(t(x))),
               jf.augment_data(x[:4], scale=jf.data_scale(x)))


# ---------------------------------------------------------------------------
# simhash helpers
# ---------------------------------------------------------------------------

class TestSimhash:
    @pytest.mark.parametrize("k", [1, 3, 5, 8])
    def test_probe_masks_identical(self, k):
        for n_codes in (1, 2, k + 1, 1 + k + k * (k - 1) // 2, 99):
            assert T.probe_masks(k, n_codes) == J.probe_masks(k, n_codes)
        with pytest.raises(ValueError):
            T.probe_masks(k, 0)

    @pytest.mark.parametrize("quadratic", [False, True])
    def test_compute_codes(self, quadratic):
        rng = np.random.default_rng(7)
        d, l, k = 11, 6, 4
        x = rng.standard_normal((200, d)).astype(np.float32)
        shape = (l * k, d, d) if quadratic else (d, l * k)
        proj = rng.standard_normal(shape).astype(np.float32)
        got = T.compute_codes(t(x), t(proj), k=k, l=l, quadratic=quadratic)
        want = J.compute_codes(x, proj, k=k, l=l, quadratic=quadratic)
        ref = (np.einsum("nd,hde,ne->nh", x, proj, x) if quadratic
               else x @ proj)
        assert_codes_match(got, want, ref, k)
        one = T.compute_codes(t(x[0]), t(proj), k=k, l=l,
                              quadratic=quadratic)
        np.testing.assert_array_equal(n(one), n(got[0]))

    def test_quadratic_forms_chunked(self, monkeypatch):
        """Row chunks give the same forms as one pass."""
        import repro_torch.core.simhash as TSH
        rng = np.random.default_rng(8)
        x = t(rng.standard_normal((37, 6)).astype(np.float32))
        m = t(rng.standard_normal((10, 6, 6)).astype(np.float32))
        whole = TSH.quadratic_forms(x, m)
        monkeypatch.setattr(TSH, "_QUADRATIC_CHUNK_ELEMS", 5 * 60)
        torch.testing.assert_close(TSH.quadratic_forms(x, m), whole)
        # float32 sums of d^2 signed terms: absolute error, not relative
        x64, m64 = n(x).astype(np.float64), n(m).astype(np.float64)
        np.testing.assert_allclose(
            n(whole), np.einsum("nd,hde,ne->nh", x64, m64, x64), atol=1e-5)

    def test_make_projections_distribution(self):
        g = torch.Generator().manual_seed(0)
        dense = T.make_projections(g, T.LSHParams(
            k=4, l=100, dim=50, family="dense"), device="cpu")
        assert dense.shape == (50, 400) and dense.dtype == torch.float32
        assert abs(float(dense.mean())) < 0.03      # 20k N(0,1): sd 0.007
        assert abs(float(dense.std()) - 1.0) < 0.03
        p = T.LSHParams(k=4, l=100, dim=50, family="sparse")
        sparse = T.make_projections(g, p, device="cpu")
        s = 1.0 / np.sqrt(p.sparsity)
        vals = np.unique(np.abs(n(sparse)))
        np.testing.assert_allclose(vals, [0.0, s], rtol=1e-6)
        frac = float((sparse != 0).float().mean())
        # binomial(20000, 1/30): sd 0.0013 -> 5 sigma
        assert abs(frac - p.sparsity) < 0.0065
        quad = T.make_projections(g, T.LSHParams(
            k=2, l=3, dim=5, family="quadratic"), device="cpu")
        assert quad.shape == (6, 5, 5)

    def test_augment_and_queries(self):
        x, y = _data(9, 20, 6)
        _close(T.augment_regression(t(x), t(y)), J.augment_regression(x, y))
        _close(T.augment_logistic(t(x), t(np.sign(y))),
               J.augment_logistic(x, np.sign(y)))
        th = x[0]
        _close(T.regression_query(t(th)), J.regression_query(th))
        _close(T.logistic_query(t(th)), J.logistic_query(th))


# ---------------------------------------------------------------------------
# the index
# ---------------------------------------------------------------------------

def _jax_index(family, x_aug, key, k=3, l=12):
    p = J.LSHParams(k=k, l=l, dim=x_aug.shape[1], family=family)
    idx = J.mutate_index(None, J.IndexMutation("build", key=key,
                                               x_aug=jnp.asarray(x_aug)), p)
    return p, idx


def _port_index(family, x_aug, jidx, k=3, l=12):
    p = T.LSHParams(k=k, l=l, dim=x_aug.shape[1], family=family)
    idx = T.mutate_index(None, T.IndexMutation(
        "build", projections=t(jidx.projections), x_aug=t(x_aug)), p)
    return p, idx


def _aug(family, x):
    return np.asarray(JF.get_family(family).augment_data(x))


def _proj_of(family, x_aug, proj):
    if family == "quadratic":
        return np.einsum("nd,hde,ne->nh", x_aug, proj, x_aug)
    return x_aug @ proj


class TestIndex:
    @pytest.mark.parametrize("family", FAMILIES)
    def test_build_and_refresh_bitwise(self, family):
        x, _ = _data(10)
        x_aug = _aug(family, x)
        jp, jidx = _jax_index(family, x_aug, jax.random.PRNGKey(3))
        tp, tidx = _port_index(family, x_aug, jidx)
        codes_t = T.hash_points(t(x_aug), tidx.projections, tp)
        codes_j = J.hash_points(jnp.asarray(x_aug), jidx.projections, jp)
        proj = _proj_of(family, x_aug, np.asarray(jidx.projections)).T
        flips = assert_codes_match(codes_t.T, np.asarray(codes_j).T,
                                   proj.T, tp.k)
        assert flips == 0, "a near-zero projection flipped: pick a new seed"
        np.testing.assert_array_equal(codes_to_numpy(tidx.sorted_codes),
                                      np.asarray(jidx.sorted_codes))
        np.testing.assert_array_equal(n(tidx.order), n(jidx.order))
        # refresh on drifted features, warm (tie-stable) and cold
        x2_aug = _aug(family, x + 0.3 * np.sin(x))
        for warm in (True, False):
            jr = J.mutate_index(jidx, J.IndexMutation(
                "refresh", x_aug=jnp.asarray(x2_aug), warm_start=warm), jp)
            tr = T.mutate_index(tidx, T.IndexMutation(
                "refresh", x_aug=t(x2_aug), warm_start=warm), tp)
            np.testing.assert_array_equal(codes_to_numpy(tr.sorted_codes),
                                          np.asarray(jr.sorted_codes))
            np.testing.assert_array_equal(n(tr.order), n(jr.order))

    def test_mutation_surface(self):
        x, _ = _data(11, 20, 4)
        tp = T.LSHParams(k=2, l=2, dim=4, family="dense")
        idx = T.mutate_index(None, T.IndexMutation(
            "build", generator=torch.Generator().manual_seed(0),
            x_aug=t(x)), tp)
        for op, need in (("delta", "ids"), ("append", "ids"),
                         ("evict", "ids"), ("refresh", "x_aug")):
            with pytest.raises(ValueError, match=f"requires {need}"):
                T.mutate_index(idx, T.IndexMutation(op), tp)
            with pytest.raises(ValueError, match="requires an index"):
                T.mutate_index(None, T.IndexMutation(op), tp)
        with pytest.raises(ValueError, match="must be one of"):
            T.IndexMutation("compact")
        with pytest.raises(ValueError, match="generator or projections"):
            T.mutate_index(None, T.IndexMutation("build", x_aug=torch.ones(
                3, 4)), T.LSHParams(k=2, l=2, dim=4, family="dense"))

    def test_live_mask_sentinel(self):
        x, _ = _data(11, 50, 5)
        jp, jidx = _jax_index("dense", x, jax.random.PRNGKey(4))
        live = np.arange(50) % 3 != 0
        jb = J.mutate_index(None, J.IndexMutation(
            "build", key=jax.random.PRNGKey(4), x_aug=jnp.asarray(x),
            live_mask=jnp.asarray(live)), jp)
        tp = T.LSHParams(k=3, l=12, dim=5, family="dense")
        tb = T.mutate_index(None, T.IndexMutation(
            "build", projections=t(jb.projections), x_aug=t(x),
            live_mask=torch.from_numpy(live)), tp)
        np.testing.assert_array_equal(codes_to_numpy(tb.sorted_codes),
                                      np.asarray(jb.sorted_codes))
        np.testing.assert_array_equal(n(tb.order), n(jb.order))
        assert int(tb.sorted_codes[:, -1].min()) == T.EMPTY_CODE

    @pytest.mark.parametrize("family", FAMILIES)
    @pytest.mark.parametrize("mp", [0, 2])
    def test_bucket_bounds(self, family, mp):
        x, _ = _data(12)
        x_aug = _aug(family, x)
        jp, jidx = _jax_index(family, x_aug, jax.random.PRNGKey(5))
        tp, tidx = _port_index(family, x_aug, jidx)
        fam = JF.get_family(family)
        q = np.asarray(fam.augment_query(
            np.random.default_rng(1).standard_normal((3, 10)).astype(
                np.float32)))
        masks = J.probe_masks(3, 1 + mp)
        if mp == 0:
            got = T.bucket_bounds_batched(tidx, t(q), tp)
            want = J.bucket_bounds_batched(jidx, jnp.asarray(q), jp)
        else:
            got = T.bucket_bounds_multi(tidx, t(q), tp, masks)
            want = J.bucket_bounds_multi(jidx, jnp.asarray(q), jp, masks)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(n(a), n(b))
        qc = T.query_codes(tidx, t(q[0]), tp)
        for a, b in zip(T.bucket_bounds(tidx, qc),
                        J.bucket_bounds(jidx, codes_from_numpy(
                            np.asarray(J.query_codes(jidx, q[0], jp))).numpy(
                            ).astype(np.uint32))):
            np.testing.assert_array_equal(n(a), n(b))


# ---------------------------------------------------------------------------
# Algorithm 1
# ---------------------------------------------------------------------------

def _sampling_case(family, seed=13):
    x, _ = _data(seed)
    x_aug = _aug(family, x)
    jp, jidx = _jax_index(family, x_aug, jax.random.PRNGKey(seed))
    tp, tidx = _port_index(family, x_aug, jidx)
    q = np.asarray(JF.get_family(family).augment_query(
        np.random.default_rng(seed).standard_normal(10).astype(np.float32)))
    return x_aug, jp, jidx, tp, tidx, q


class TestSampler:
    @pytest.mark.parametrize("family", FAMILIES)
    @pytest.mark.parametrize("mp", [0, 2])
    def test_sample(self, family, mp):
        x_aug, jp, jidx, tp, tidx, q = _sampling_case(family)
        key = jax.random.PRNGKey(21)
        m, probes = 64, 6          # few probes: some repetitions fall back
        want = JS.sample(key, jidx, jnp.asarray(x_aug), jnp.asarray(q), jp,
                         m=m, max_probes=probes, multiprobe=mp)
        draws = jax_sample_draws(key, m, probes, tp.l, x_aug.shape[0])
        got = TS.sample(None, tidx, t(x_aug), t(q), tp, m=m,
                        max_probes=probes, multiprobe=mp, draws=draws)
        assert_results_match(got, want)

    @pytest.mark.parametrize("family", ["quadratic", "mips"])
    @pytest.mark.parametrize("mp", [0, 2])
    def test_sample_batched(self, family, mp):
        x_aug, jp, jidx, tp, tidx, q = _sampling_case(family, seed=14)
        qs = np.stack([q, -q, np.roll(q, 1)])
        key = jax.random.PRNGKey(22)
        want = JS.sample_batched(key, jidx, jnp.asarray(x_aug),
                                 jnp.asarray(qs), jp, m=5, multiprobe=mp)
        draws = jax_sample_draws(key, 5, 2 * tp.l, tp.l, x_aug.shape[0],
                                 batch=3)
        got = TS.sample_batched(None, tidx, t(x_aug), t(qs), tp, m=5,
                                multiprobe=mp, draws=draws)
        assert got.indices.shape == (3, 5)
        assert_results_match(got, want)

    @pytest.mark.parametrize("family", ["dense", "quadratic"])
    def test_sample_drain(self, family):
        x_aug, jp, jidx, tp, tidx, q = _sampling_case(family, seed=15)
        key = jax.random.PRNGKey(23)
        want = JS.sample_drain(key, jidx, jnp.asarray(x_aug), jnp.asarray(q),
                               jp, m=9)
        draws = jax_drain_draws(key, 9, 2 * tp.l, tp.l, x_aug.shape[0])
        got = TS.sample_drain(None, tidx, t(x_aug), t(q), tp, m=9,
                              draws=draws)
        assert_results_match(got, want)

    def test_generator_draws(self):
        x_aug, _, _, tp, tidx, q = _sampling_case("dense", seed=16)
        res = TS.sample(torch.Generator().manual_seed(0), tidx, t(x_aug),
                        t(q), tp, m=32, multiprobe=2)
        assert res.indices.shape == (32,)
        assert bool(((res.probs > 0) & (res.probs <= 1)).all())
        with pytest.raises(ValueError, match="Generator"):
            TS.sample(None, tidx, t(x_aug), t(q), tp, m=2)

    def test_uniform_below(self):
        u = torch.tensor([0.0, 0.5, 0.9999999, 0.3])
        b = torch.tensor([3, 4, 7, 1], dtype=torch.int32)
        np.testing.assert_array_equal(n(TS._uniform_below(u, b)),
                                      [0, 2, 6, 0])


# ---------------------------------------------------------------------------
# estimator + preprocessing
# ---------------------------------------------------------------------------

class TestEstimator:
    def test_weights_and_gradient(self):
        # test_sample's dense case: the reference's jitted sampler and
        # index build are compiled once for both
        x_aug, jp, jidx, tp, tidx, q = _sampling_case("dense")
        key = jax.random.PRNGKey(24)
        want = JS.sample(key, jidx, jnp.asarray(x_aug), jnp.asarray(q), jp,
                         m=64, max_probes=6)
        got = TS.sample(None, tidx, t(x_aug), t(q), tp, m=64, max_probes=6,
                        draws=jax_sample_draws(key, 64, 6, tp.l,
                                               x_aug.shape[0]))
        for floor in (0.0, 1e-3):
            _close(TE.importance_weights(got, 400, floor),
                   JE.importance_weights(want, 400, floor))
        x, y = _data(13)
        theta = np.random.default_rng(2).standard_normal(10).astype(
            np.float32)
        idx = np.asarray(want.indices)
        for jg, tg in ((JL.squared_loss_grad, TL.squared_loss_grad),
                       (JL.logistic_loss_grad, TL.logistic_loss_grad)):
            _close(TE.lgd_gradient(tg, t(theta), t(x[idx]), t(y[idx]), got,
                                   400),
                   JE.lgd_gradient(jg, theta, x[idx], y[idx], want, 400))

    @pytest.mark.parametrize("mp", [0, 2])
    def test_exact_inclusion_probability(self, mp):
        x_aug, jp, _, tp, _, q = _sampling_case("dense")
        for l in (1, 3):
            _close(TE.exact_inclusion_probability(t(x_aug), t(q), tp, l=l,
                                                  multiprobe=mp),
                   JE.exact_inclusion_probability(x_aug, q, jp, l=l,
                                                  multiprobe=mp))

    def test_variance_report(self):
        rng = np.random.default_rng(3)
        g2, pb, ck = (rng.uniform(0.1, 2.0, 50).astype(np.float32)
                      for _ in range(3))
        full = np.float32(4.0)
        got = TE.variance_report(t(g2), t(pb), t(ck), t(full))
        want = JE.variance_report(g2, pb, ck, full)
        for a, b in zip(got, want):
            _close(a, b)
        est = rng.standard_normal((30, 4)).astype(np.float32)
        _close(TE.empirical_estimator_covariance_trace(t(est)),
               JE.empirical_estimator_covariance_trace(est))

    def test_preprocess(self):
        x, y = _data(18)
        ys = np.sign(y)
        pairs = [(TL.preprocess_regression(t(x), t(y)),
                  JL.preprocess_regression(x, y)),
                 (TL.preprocess_logistic(t(x), t(ys)),
                  JL.preprocess_logistic(x, ys)),
                 (TL.preprocess_regression_mips(t(x), t(y),
                                                TF.get_family("mips")),
                  JL.preprocess_regression_mips(x, y, JF.get_family("mips"))),
                 (TL.preprocess_logistic_mips(t(x), t(ys),
                                              TF.get_family("mips")),
                  JL.preprocess_logistic_mips(x, ys, JF.get_family("mips")))]
        for got, want in pairs:
            for a, b in zip(got, want):
                _close(a, b)
