"""The port's banded (norm-ranged) MIPS family against the JAX package.

Inputs come from numpy seeds; both packages get the same ones, and the
port builds on the reference's projections and draws (rebuilt from the
same JAX key in ``tests/_torch_parity.py``):

* ``BandedScale`` boundaries and scales (rtol 1e-6: both take the same
  sorted norms, which may part in their last bit), the upper-band tie
  rule, an all-dead corpus; ``x_aug`` at 1e-6 (its Simple-LSH tail as
  tail^2, see ``test_augmentation``); a subset re-augmented at the
  pinned scale bitwise the full augmentation's rows.
* Tagged codes bitwise when both hash the REFERENCE's x_aug; the
  projections' band row zero; ``band_starts`` and ``bucket_bounds_banded``
  bitwise; the flat families' hooks no-ops.
* Banded ``sample`` / ``sample_batched`` / ``sample_gather_batched``
  against ``_sample_one_banded`` with the reference's four-way key
  split as ``band_u`` / ``fallback_u``: ids, ``n_probes``, ``probe_code``
  and fallback bitwise, p and weights at the golden-pin tolerance
  (rtol 1e-5, atol 1e-7).
* The quickstart's LGD on a pareto corpus (N 50,000): the port follows
  the reference for 300 steps, and the reference's own banded loss
  rises there while plain ``mips`` falls.
* The delta / append / evict merges of tagged codes bitwise against
  ``repro.core.mutate_index``; an evicted-empty band never drawn.
* ``LSHSampledPipeline(family="mips_banded")`` against the reference's
  (features 1e-6, index bitwise, batches with the reference's draws),
  and the port's own delta / async refresh and restore replay with the
  ``BandedScale`` pinned.
* The reference's statistical guards with the port's own draws:
  E[1/(pN)] = 1 on the log-normal corpus where plain ``mips`` fails
  (the reference's sizes: N 2,000, d 32, K 3, L 100, 8 builds, m 2,000),
  and after a band is evicted empty.
* The surface ``repro.core`` and ``repro.data`` export that the port
  lacked: ``family_names``, the banded names and the health ladder's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.sampler as JS
import repro.data as JD
import repro_torch.core as T
import repro_torch.data as TD
from _stats import mean_band
from _torch_parity import (ATOL, RTOL, assert_results_match,
                           jax_banded_draws, jax_sample_draws, n, t)
from repro_torch import convert

JF, TF = J.get_family("mips_banded"), T.get_family("mips_banded")
NB = TF.num_bands()


def _heavy_tail(n_rows, d, seed=8, sigma=0.8):
    """Unit directions times log-normal norms, and a raw query: the corpus
    where one global Simple-LSH scale fails."""
    rng = np.random.default_rng(seed)
    dirs = rng.standard_normal((n_rows, d))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    x = dirs * np.exp(sigma * rng.standard_normal((n_rows, 1)))
    return x.astype(np.float32), rng.standard_normal(d).astype(np.float32)


def _params(k, l, d, family="mips_banded"):
    dim = J.get_family(family).aug_dim(d)
    return (J.LSHParams(k=k, l=l, dim=dim, family=family),
            T.LSHParams(k=k, l=l, dim=dim, family=family))


def _both(x, k=3, l=12, key=1, live_mask=None):
    """The same banded index in both packages: the reference builds on
    its own x_aug and projections; the port on the same two."""
    pj, pt = _params(k, l, x.shape[1])
    scale = JF.data_scale(jnp.asarray(x))
    xa = JF.augment_data(jnp.asarray(x), scale=scale)
    lm = None if live_mask is None else jnp.asarray(live_mask)
    ij = J.mutate_index(None, J.IndexMutation(
        "build", key=jax.random.PRNGKey(key), x_aug=xa, live_mask=lm), pj)
    it = T.mutate_index(None, T.IndexMutation(
        "build", projections=t(ij.projections), x_aug=t(xa),
        live_mask=None if live_mask is None else t(live_mask)), pt)
    return pj, pt, xa, ij, it


def _assert_index_equal(got, want):
    np.testing.assert_array_equal(convert.codes_to_numpy(got.sorted_codes),
                                  np.asarray(want.sorted_codes))
    np.testing.assert_array_equal(n(got.order), np.asarray(want.order))


# -- the scale, the tie rule, the augmentation ---------------------------------

class TestBandedScale:
    @pytest.mark.parametrize("n_rows,d,seed", [(400, 6, 8), (64, 4, 3),
                                               (1000, 32, 5)])
    def test_boundaries_and_scales(self, n_rows, d, seed):
        x, _ = _heavy_tail(n_rows, d, seed)
        sj, st = JF.data_scale(jnp.asarray(x)), TF.data_scale(t(x))
        assert isinstance(st, T.BandedScale)
        for got, want in zip(st, sj):
            np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-6)
        np.testing.assert_array_equal(
            n(TF.band_of_norms(torch.linalg.vector_norm(t(x), dim=-1),
                               st.boundaries)),
            np.asarray(JF.band_of_norms(jnp.linalg.norm(x, axis=-1),
                                        sj.boundaries)))

    def test_row_on_a_boundary_joins_the_upper_band(self):
        x, _ = _heavy_tail(64, 4)
        st = TF.data_scale(t(x))
        np.testing.assert_array_equal(
            n(TF.band_of_norms(st.boundaries, st.boundaries)),
            np.arange(1, NB))

    def test_all_dead_corpus(self):
        """Zero rows: no live norm to split on, boundaries 0, every
        scale the 1e-30 guard, every row in the top band."""
        x = np.zeros((20, 5), np.float32)
        sj, st = JF.data_scale(jnp.asarray(x)), TF.data_scale(t(x))
        for got, want in zip(st, sj):
            np.testing.assert_array_equal(n(got), np.asarray(want))
        np.testing.assert_array_equal(n(st.boundaries), 0.0)
        np.testing.assert_array_equal(
            n(TF.augment_data(t(x), scale=st)),
            np.asarray(JF.augment_data(jnp.asarray(x), scale=sj)))

    def test_augmentation(self):
        """x_aug at 1e-6, the band coordinate exact; a subset at the
        pinned scale bitwise the full augmentation's rows.  The tail
        sqrt(1 - |x/M|^2) of a band's max-norm row magnifies a last-bit
        difference of |x/M|^2 (the two packages sum it in another order)
        to ~2e-4, so the tail is held as tail^2 = 1 - |x/M|^2, the
        quantity both compute to 1e-6."""
        x, q = _heavy_tail(200, 6)
        st = TF.data_scale(t(x))
        xa = TF.augment_data(t(x), scale=st)
        want = np.asarray(JF.augment_data(jnp.asarray(x)))
        assert xa.shape == (200, TF.aug_dim(6))
        body = [*range(6), 7]
        np.testing.assert_allclose(n(xa)[:, body], want[:, body],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(n(xa)[:, 6] ** 2, want[:, 6] ** 2,
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(n(xa[:, -1]), want[:, -1])
        np.testing.assert_array_equal(
            n(TF.augment_data(t(x[50:70]), scale=st)), n(xa[50:70]))
        np.testing.assert_allclose(
            n(TF.augment_query(t(q))),
            np.asarray(JF.augment_query(jnp.asarray(q))), rtol=1e-6)

    def test_collision_law_leaves_out_the_band(self):
        x, q = _heavy_tail(50, 7)
        xa = JF.augment_data(jnp.asarray(x))
        qa = JF.augment_query(jnp.asarray(q))
        np.testing.assert_allclose(
            n(TF.collision_prob(t(xa), t(qa))),
            np.asarray(JF.collision_prob(xa, qa)), rtol=1e-6)
        assert TF.law_dim(TF.aug_dim(7)) == 8 and TF.cp_law == "angle"


# -- codes, starts and bounds ---------------------------------------------------

class TestBandedCodes:
    def test_tagged_codes_on_the_references_x_aug(self):
        x, _ = _heavy_tail(300, 8)
        pj, pt, xa, ij, it = _both(x)
        want = np.asarray(J.hash_points(xa, ij.projections, pj))
        got = T.hash_points(t(xa), it.projections, pt)
        np.testing.assert_array_equal(convert.codes_to_numpy(got), want)
        _assert_index_equal(it, ij)
        # band tags ascend along every table's order
        tags = n(it.sorted_codes) >> pt.k
        assert (np.diff(tags, axis=1) >= 0).all()

    def test_projection_band_row_is_zero(self):
        _, pt = _params(3, 8, 6)
        proj = T.make_projections(torch.Generator().manual_seed(10), pt,
                                  "cpu")
        assert (proj[-1] == 0).all() and (proj[:-1] != 0).any()

    @pytest.mark.parametrize("name", ["dense", "sparse", "quadratic",
                                      "mips"])
    def test_flat_family_hooks_are_no_ops(self, name):
        fam = T.get_family(name)
        x = torch.randn((5, 4), generator=torch.Generator().manual_seed(1))
        assert fam.num_bands() == 1 and fam.code_tags(x, 3) is None
        assert fam.mask_projections(x) is x and fam.law_dim(4) == 4

    def test_code_width_guards(self):
        assert TF.code_width(3) == 3 + (NB - 1).bit_length()
        with pytest.raises(ValueError, match="code width"):
            T.LSHParams(k=30, l=2, dim=8, family="mips_banded")
        with pytest.raises(ValueError, match="code_width"):
            TD.LSHPipelineConfig(streaming=True, k=29, family="mips_banded")
        TD.LSHPipelineConfig(streaming=True, k=28, family="mips_banded")

    @pytest.mark.parametrize("mp", [0, 2])
    def test_band_starts_and_bounds(self, mp):
        x, q = _heavy_tail(300, 8, seed=4)
        pj, pt, xa, ij, it = _both(x, k=3, l=10)
        np.testing.assert_array_equal(n(T.band_starts(it, pt)),
                                      np.asarray(J.band_starts(ij, pj)))
        rng = np.random.default_rng(6)
        qs = rng.standard_normal((3, 8)).astype(np.float32)
        masks = J.probe_masks(3, 1 + mp)
        for qq in (qs, q):
            qa = JF.augment_query(jnp.asarray(qq))
            lo_j, hi_j = J.bucket_bounds_banded(ij, qa, pj, masks,
                                                use_pallas=False)
            lo_t, hi_t = T.bucket_bounds_banded(it, t(qa), pt, masks)
            assert lo_t.shape == lo_j.shape == qa.shape[:-1] + (
                NB, len(masks), 10)
            np.testing.assert_array_equal(n(lo_t), np.asarray(lo_j))
            np.testing.assert_array_equal(n(hi_t), np.asarray(hi_j))


# -- the banded draw --------------------------------------------------------------

class TestBandedDraws:
    @pytest.mark.parametrize("mp", [0, 2])
    def test_sample(self, mp):
        x, q = _heavy_tail(300, 8)
        pj, pt, xa, ij, it = _both(x)
        qa = JF.augment_query(jnp.asarray(q))
        key = jax.random.PRNGKey(5)
        want = JS.sample(key, ij, xa, qa, pj, m=64, multiprobe=mp)
        draws = jax_banded_draws(key, 64, 24, 12)
        got = T.sample(None, it, t(xa), t(qa), pt, m=64, multiprobe=mp,
                       draws=draws)
        assert_results_match(got, want)

    @pytest.mark.parametrize("mp", [0, 2])
    def test_sample_batched_with_fallbacks(self, mp):
        """K 6 over 300 rows: sparse buckets, so some walks fall back to
        the bands' live prefix."""
        x, _ = _heavy_tail(300, 8, seed=11)
        pj, pt, xa, ij, it = _both(x, k=6, l=4)
        qs = np.random.default_rng(12).standard_normal((5, 8)).astype(
            np.float32)
        qa = JF.augment_query(jnp.asarray(qs))
        key = jax.random.PRNGKey(13)
        want = JS.sample_batched(key, ij, xa, qa, pj, m=32, max_probes=4,
                                 multiprobe=mp)
        draws = jax_banded_draws(key, 32, 4, 4, batch=5)
        got = T.sample_batched(None, it, t(xa), t(qa), pt, m=32,
                               max_probes=4, multiprobe=mp, draws=draws)
        assert_results_match(got, want)
        assert bool(got.fallback.any()) and not bool(got.fallback.all())

    def test_sample_gather_batched(self):
        x, _ = _heavy_tail(300, 8, seed=14)
        pj, pt, xa, ij, it = _both(x)
        store = np.random.default_rng(15).integers(
            0, 1000, (300, 9)).astype(np.int32)
        qs = np.random.default_rng(16).standard_normal((3, 8)).astype(
            np.float32)
        qa = JF.augment_query(jnp.asarray(qs))
        key = jax.random.PRNGKey(17)
        want = JS.sample_gather_batched(key, ij, xa, qa, jnp.asarray(store),
                                        pj, m=8, multiprobe=1,
                                        use_pallas=False)
        got = T.sample_gather_batched(
            None, it, t(xa), t(qa), t(store), pt, m=8, multiprobe=1,
            draws=jax_banded_draws(key, 8, 24, 12, batch=3))
        for f in ("tokens", "targets", "example_ids", "indices",
                  "fallback", "probe_code"):
            np.testing.assert_array_equal(
                n(getattr(got, f)).astype(np.int64),
                np.asarray(getattr(want, f)).astype(np.int64), err_msg=f)
        for f in ("probs", "loss_weights"):
            np.testing.assert_allclose(n(getattr(got, f)),
                                       np.asarray(getattr(want, f)),
                                       rtol=RTOL, atol=ATOL, err_msg=f)

    def test_generator_draws(self):
        """The port's own draws: band_u and fallback_u drawn from the
        generator, two calls with one seed equal, weights positive."""
        x, q = _heavy_tail(300, 8)
        _, pt, xa, _, it = _both(x)
        qa = TF.augment_query(t(q))
        a, b = (T.sample(torch.Generator().manual_seed(3), it, t(xa), qa,
                         pt, m=16) for _ in range(2))
        for fa, fb in zip(a, b):
            assert torch.equal(fa, fb)
        assert bool((a.probs > 0).all())

    def test_lgd_trajectory(self):
        """10 banded LGD steps (regression, sgd, multiprobe 2) on the
        reference's x_aug, index and draws: theta at rtol 1e-4 (the
        golden pin widened by 10 steps of f32 updates, as
        tests/test_torch_lgd.py holds the flat families)."""
        import repro.optim as JO
        import repro_torch.optim as TO

        x, _ = _heavy_tail(400, 10, seed=21)
        rng = np.random.default_rng(22)
        y = (x @ rng.standard_normal(10)).astype(np.float32)
        dim = JF.aug_dim(11)
        probs = [mod.LGDProblem(kind="regression", lsh=mod.LSHParams(
            k=3, l=8, dim=dim, family="mips_banded"), minibatch=8,
            multiprobe=2, p_floor=1e-6) for mod in (J, T)]
        jopt, topt = (mod.make_optimizer("sgd", 0.01) for mod in (JO, TO))
        key = jax.random.PRNGKey(7)
        js, jxt, jyt, jxa = J.init(key, probs[0], jnp.asarray(x),
                                   jnp.asarray(y), jopt)
        ts = convert.lgd_state_from_numpy(js)
        txt, tyt, txa = t(jxt), t(jyt), t(jxa)
        for step in range(10):
            k = jax.random.fold_in(key, step)
            js, jm = J.lgd_step(k, js, jxt, jyt, jxa, probs[0], jopt)
            ts, tm = T.lgd_step(None, ts, txt, tyt, txa, probs[1], topt,
                                draws=jax_banded_draws(k, 8, 16, 8))
            np.testing.assert_allclose(n(tm["sample_prob_mean"]),
                                       np.asarray(jm["sample_prob_mean"]),
                                       rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(n(ts.theta), np.asarray(js.theta),
                                   rtol=1e-4, atol=1e-6)

    @pytest.mark.parametrize("family,mp,rises", [
        ("mips_banded", 0, True), ("mips_banded", 2, True),
        ("mips", 0, False)])
    def test_quickstart_loss_trend_on_a_pareto_corpus(self, family, mp,
                                                      rises, capsys):
        """The quickstart's LGD (regression, K 5, L 100, m 16, p_floor
        1e-7, sgd at 5e-2/90) on the port's pareto corpus, seed 2, N cut
        from chip_smoke's 463,715 to 50,000 to fit the test's time: 300
        steps of the reference, and of the port on the reference's index
        and draws.  The port follows the reference (theta and the loss at
        rtol 1e-4, atol 1e-6, at steps 150 and 300), and the reference's
        own banded loss ends ABOVE its start at both multiprobe settings
        while plain mips on the same corpus and keys falls: why
        chip_smoke's 4e reports the banded trend and gates the card
        against the CPU's plain path instead.  The losses are printed
        (``pytest -s``)."""
        import repro.optim as JO
        import repro_torch.optim as TO

        steps = 300
        ds = TD.make_regression(torch.Generator().manual_seed(2),
                                "yearmsd-like", n_train=50_000, d=90,
                                noise="pareto", device="cpu")
        dim = J.get_family(family).aug_dim(91)
        probs = [mod.LGDProblem(kind="regression", lsh=mod.LSHParams(
            k=5, l=100, dim=dim, family=family), minibatch=16,
            multiprobe=mp, p_floor=1e-7) for mod in (J, T)]
        jopt, topt = (mod.make_optimizer("sgd", 5e-2 / 90)
                      for mod in (JO, TO))
        key = jax.random.PRNGKey(2)
        js, jxt, jyt, jxa = J.init(key, probs[0], jnp.asarray(n(
            ds.x_train)), jnp.asarray(n(ds.y_train)), jopt)
        ts = convert.lgd_state_from_numpy(js)
        txt, tyt, txa = t(jxt), t(jyt), t(jxa)
        jstep = jax.jit(lambda k_, s_: J.lgd_step(k_, s_, jxt, jyt, jxa,
                                                  probs[0], jopt))
        draws = (jax_banded_draws if family == "mips_banded" else
                 lambda k_, *a: jax_sample_draws(k_, *a, ds.x_train.shape[0]))
        loss = {"ref": [], "port": []}
        stream = jax.random.PRNGKey(102)
        for step in range(steps + 1):
            if step in (0, steps // 2, steps):
                loss["ref"].append(float(J.full_loss(js.theta, jxt, jyt,
                                                     probs[0])))
                loss["port"].append(float(T.full_loss(ts.theta, txt, tyt,
                                                      probs[1])))
                np.testing.assert_allclose(n(ts.theta), np.asarray(js.theta),
                                           rtol=1e-4, atol=1e-6)
            if step == steps:
                break
            k = jax.random.fold_in(stream, step)
            js, _ = jstep(k, js)
            ts, _ = T.lgd_step(None, ts, txt, tyt, txa, probs[1], topt,
                               draws=draws(k, 16, 200, 100))
        np.testing.assert_allclose(loss["port"], loss["ref"], rtol=1e-4)
        with capsys.disabled():
            print(f"\n{family}/mp{mp} N 50,000 seed 2, loss at steps 0, "
                  f"150, 300: reference {loss['ref']}, port {loss['port']}")
        assert (loss["ref"][-1] > loss["ref"][0]) == rises

    def test_drain_refuses_banded(self):
        x, q = _heavy_tail(64, 4)
        _, pt, xa, _, it = _both(x)
        with pytest.raises(ValueError, match="banded"):
            T.sample_drain(torch.Generator(), it, t(xa),
                           TF.augment_query(t(q)), pt)

    def test_inclusion_probability_band_select(self):
        x, q = _heavy_tail(24, 8, seed=7)
        xa = JF.augment_data(jnp.asarray(x))
        qa = JF.augment_query(jnp.asarray(q))
        pj, pt = _params(3, 5, 8)
        share = np.random.default_rng(3).random(24).astype(np.float32)
        want = J.exact_inclusion_probability(
            xa, qa, pj, l=2, multiprobe=2, band_select=jnp.asarray(share))
        got = T.exact_inclusion_probability(
            t(xa), t(qa), pt, l=2, multiprobe=2, band_select=t(share))
        np.testing.assert_allclose(n(got), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


# -- the merges -------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_banded_merges_match_the_reference(seed):
    """Random append / evict / delta (rows drifting across bands) on a
    capacity-managed banded index: sorted_codes, order and band_starts
    bitwise against repro.core.mutate_index on the same tagged codes."""
    rng = np.random.default_rng(seed)
    n_rows, cap, d = 48, 64, 6
    raw = np.zeros((cap, d), np.float32)
    raw[:n_rows], _ = _heavy_tail(n_rows, d, seed=int(rng.integers(99)))
    live = np.zeros(cap, bool)
    live[:n_rows] = True
    pj, pt, _, ij, it = _both(raw, k=3, l=6, key=33, live_mask=live)
    scale = JF.data_scale(jnp.asarray(raw))

    def codes(rows):
        return J.hash_points(JF.augment_data(jnp.asarray(rows), scale=scale),
                             ij.projections, pj)

    for op in ("append", "evict", "delta", "evict", "append", "delta"):
        if op == "append":
            ids = np.flatnonzero(~live)[:4].astype(np.int32)
            raw[ids], _ = _heavy_tail(4, d, seed=int(rng.integers(99)))
            live[ids] = True
        elif op == "evict":
            ids = rng.choice(np.flatnonzero(live), 4,
                             replace=False).astype(np.int32)
            live[ids] = False
        else:
            ids = rng.choice(np.flatnonzero(live), 4,
                             replace=False).astype(np.int32)
            raw[ids] *= rng.uniform(0.25, 4.0, (4, 1)).astype(np.float32)
        if op == "evict":
            ij = J.mutate_index(ij, J.IndexMutation(
                "evict", ids=jnp.asarray(ids)), pj)
            it = T.mutate_index(it, T.IndexMutation(
                "evict", ids=t(ids, torch.int64)), pt)
        else:
            c = codes(raw[ids])
            ij = J.mutate_index(ij, J.IndexMutation(
                op, ids=jnp.asarray(ids), codes=c))
            it = T.mutate_index(it, T.IndexMutation(
                op, ids=t(ids, torch.int64), codes=t(c)))
        _assert_index_equal(it, ij)
        np.testing.assert_array_equal(n(T.band_starts(it, pt)),
                                      np.asarray(J.band_starts(ij, pj)))
    assert int(n(T.band_starts(it, pt))[-1]) == int(live.sum())


# -- the pipeline -------------------------------------------------------------------

VOCAB, DIM, SEQ = 40, 12, 7
# integer embeddings: the raw features (sums) are exact in both packages
EMBED = np.random.default_rng(2).integers(-4, 5, (VOCAB, DIM)).astype(
    np.float32)
SALT_STEP = 0x057E9


def _t_feature(params, chunk):
    return params["embed"][chunk].sum(1)


def _j_feature(params, chunk):
    return jnp.sum(params["embed"][chunk], axis=1)


def _tokens(n_rows=64, seed=3):
    return np.random.default_rng(seed).integers(
        0, VOCAB, (n_rows, SEQ)).astype(np.int32)


def _cfg(make, **kw):
    for k, v in dict(k=3, l=8, minibatch=8, refresh_every=0,
                     family="mips_banded").items():
        kw.setdefault(k, v)
    return make(**kw)


def _pipe(tokens=None, projections=None, **kw):
    return TD.LSHSampledPipeline(
        4, _tokens() if tokens is None else tokens, _t_feature,
        lambda p: p["q"], _cfg(TD.LSHPipelineConfig, **kw),
        params={"embed": torch.from_numpy(EMBED.copy()),
                "q": torch.ones(DIM)}, device="cpu",
        projections=projections)


def test_pipeline_matches_the_reference():
    """The dense banded pipeline through a full refresh: BandedScale at
    1e-6, features at 1e-6, the index bitwise, batches with the
    reference's draws (tokens and ids bitwise, weights rtol 1e-5)."""
    toks = _tokens()
    ref = JD.LSHSampledPipeline(
        jax.random.PRNGKey(4), toks, _j_feature, lambda p: p["q"],
        _cfg(JD.LSHPipelineConfig, refresh_every=3, use_pallas=False),
        params={"embed": jnp.asarray(EMBED), "q": jnp.ones(DIM)})
    got = _pipe(toks, projections=t(ref.index.projections), refresh_every=3)
    assert got.lsh.dim == DIM + 2
    for a, b in zip(got._feat_scale, ref._feat_scale):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-6)
    fg, fj = n(got.features), np.asarray(ref.features)
    body = [*range(DIM), DIM + 1]      # the tail as in test_augmentation
    np.testing.assert_allclose(fg[:, body], fj[:, body], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(fg[:, DIM] ** 2, fj[:, DIM] ** 2, rtol=0,
                               atol=1e-6)
    _assert_index_equal(got.index, ref.index)
    stream = jax.random.fold_in(jax.random.PRNGKey(4), SALT_STEP)
    for step in range(5):
        draws = jax_banded_draws(jax.random.fold_in(stream, step), 8,
                                 max(2 * got.lsh.l, 8), got.lsh.l)
        bj, bt = ref.next_batch(), got.next_batch(draws=draws)
        for k in ("tokens", "targets", "example_ids"):
            np.testing.assert_array_equal(
                n(bt[k]).astype(np.int64),
                np.asarray(bj[k]).astype(np.int64), err_msg=k)
        np.testing.assert_allclose(n(bt["loss_weights"]),
                                   np.asarray(bj["loss_weights"]),
                                   rtol=RTOL, atol=ATOL)
    assert got._refresh_count == ref._refresh_count == 1
    _assert_index_equal(got.index, ref.index)


def test_pipeline_delta_async_and_restore():
    """A streaming banded pipeline with delta refreshes: the async run
    draws bitwise the batches of the sync run; the BandedScale stays
    pinned across delta refreshes; a restore_at replays the run."""
    kw = dict(window=48, streaming=True, refresh_every=3,
              refresh_mode="delta", drift_frac=0.25)
    runs = {}
    for asynchronous in (False, True):
        pipe = _pipe(_tokens(48), refresh_async=asynchronous, **kw)
        scale0 = [f.clone() for f in pipe._feat_scale]
        out = [pipe.next_batch() for _ in range(4)]
        pipe.append_rows(_tokens(6, seed=31))
        out += [pipe.next_batch() for _ in range(4)]
        pipe.finalize()
        assert pipe._refresh_count >= 2
        assert all(torch.equal(a, b) for a, b in zip(scale0,
                                                     pipe._feat_scale))
        runs[asynchronous] = (out, pipe)
    for ba, bb in zip(runs[False][0], runs[True][0]):
        for k in ba:
            assert torch.equal(ba[k], bb[k]), k
    pipe = runs[False][1]
    step = pipe._step
    pipe.restore_at(step)
    first = [pipe.next_batch() for _ in range(3)]
    pipe.restore_at(step)
    for a in first:
        b = pipe.next_batch()
        for k in a:
            assert torch.equal(a[k], b[k]), k


# -- the statistical guards, with the port's own draws -------------------------

def _calibration(fam_name, x, q_raw, k, l, n_builds, m, seed=11):
    """(grand E[1/(pN)], per-build sd, mean tables probed) over index
    builds, each with its own projections and draws."""
    n_rows = x.shape[0]
    fam = T.get_family(fam_name)
    xa = fam.augment_data(t(x))
    qa = fam.augment_query(t(q_raw))
    p = T.LSHParams(k=k, l=l, dim=xa.shape[-1], family=fam_name)
    means, probes = [], []
    for b in range(n_builds):
        g = torch.Generator().manual_seed(1000 * seed + b)
        index = T.mutate_index(None, T.IndexMutation(
            "build", generator=g, x_aug=xa), p)
        res = T.sample(g, index, xa, qa, p, m=m)
        means.append(float((1.0 / (res.probs.double() * n_rows)).mean()))
        probes.append(float(res.n_probes.float().mean()))
    means = np.asarray(means)
    return float(means.mean()), float(means.std()), float(np.mean(probes))


def _reference_heavy_tail(n_rows, d, seed=8, sigma=0.8):
    """The reference's own log-normal corpus and query
    (tests/test_norm_ranging.py ``_heavy_tail``), as numpy."""
    kx, kn, kq = jax.random.split(jax.random.PRNGKey(seed), 3)
    dirs = J.families.normalize_rows(jax.random.normal(kx, (n_rows, d)))
    norms = jnp.exp(sigma * jax.random.normal(kn, (n_rows, 1)))
    return np.asarray(dirs * norms), np.asarray(jax.random.normal(kq, (d,)))


@pytest.mark.statistical
def test_unit_inverse_probability_where_plain_mips_fails():
    """Banded E[1/(pN)] = 1 on the reference's log-normal corpus and in
    its regime (tests/test_norm_ranging.py:257: N 2,000, d 32, K 3,
    L 100, 8 builds of m 2,000 draws), where plain mips is far from 1.
    Measured with the port's draws: banded grand 1.0736, per-build sd
    0.1088, mean probes 1.0748 (the residual above 1 is the regime's
    misses, mean probes > 1); plain mips 1.6577, sd 0.3840.
    Bands as the reference's: banded 1 +- max(0.1, 3 sigma / sqrt(8)),
    plain |grand - 1| > 0.3, and the banded spread below plain's."""
    x, q = _reference_heavy_tail(2000, 32)
    grand_b, sd_b, probes_b = _calibration("mips_banded", x, q, 3, 100, 8,
                                           2000)
    assert probes_b < 1.15, f"banded regime drifted: mean_l={probes_b}"
    assert abs(grand_b - 1.0) < max(0.1, mean_band(sd_b, 8)), (
        f"banded E[1/(pN)] = {grand_b:.4f} (sd {sd_b:.4f})")
    grand_p, sd_p, _ = _calibration("mips", x, q, 3, 100, 8, 2000)
    assert abs(grand_p - 1.0) > 0.3, f"plain mips E[1/(pN)] = {grand_p}"
    assert sd_b < sd_p


@pytest.mark.statistical
def test_empty_band_after_evict_stays_unbiased():
    """Evict every row of band 3 of the reference's corpus
    (tests/test_norm_ranging.py:413): its region is empty, no draw comes
    from it, and E[1/(p n_live)] stays near 1 over the survivors, the
    band shares read off the live index.  Averaged over 32 index builds
    (the identity is an expectation over hash functions) of m 4,000
    draws each, not the reference's one.  Measured: 1.1708 with the
    port's draws (the residual above 1 is the regime's misses: mean
    probes above 1).  The band is the reference's 0.25."""
    n_rows, d = 256, 6
    x, q = _reference_heavy_tail(n_rows, d, seed=19)
    st = TF.data_scale(t(x))
    bands = n(TF.band_of_norms(torch.linalg.vector_norm(t(x), dim=-1),
                               st.boundaries))
    xa = TF.augment_data(t(x), scale=st)
    qa = TF.augment_query(t(q))
    p = T.LSHParams(k=2, l=24, dim=d + 2, family="mips_banded")
    victims = np.flatnonzero(bands == 3)
    assert victims.size > 0
    n_live = n_rows - victims.size
    means = []
    for b in range(32):
        g = torch.Generator().manual_seed(20 + b)
        index = T.mutate_index(None, T.IndexMutation(
            "build", generator=g, x_aug=xa,
            live_mask=torch.ones(n_rows, dtype=torch.bool)), p)
        index = T.mutate_index(index, T.IndexMutation(
            "evict", ids=torch.from_numpy(victims)), p)
        starts = n(T.band_starts(index, p))
        assert starts[4] == starts[3] and starts[-1] == n_live
        res = T.sample(g, index, xa, qa, p, m=4000)
        assert not np.isin(n(res.indices), victims).any()
        means.append(float((1.0 / (res.probs.double() * n_live)).mean()))
    inv = float(np.mean(means))
    assert abs(inv - 1.0) < 0.25, f"E[1/(p n_live)] = {inv:.4f}"


# -- the surface the reference exports ---------------------------------------------

@pytest.mark.parametrize("module,names", [
    ("core", ("BandedScale", "NormRangedMIPSFamily", "family_names",
              "band_starts", "bucket_bounds_banded")),
    ("data", ("HealthConfig", "HealthMonitor", "HEALTHY", "STALE_INDEX",
              "UNIFORM_FALLBACK")),
])
def test_exports_match_the_reference(module, names):
    """Names the reference's package exports that the port lacked (the
    cluster health names wait for the sharded pipeline)."""
    jm, tm = {"core": (J, T), "data": (JD, TD)}[module]
    for name in names:
        assert hasattr(jm, name) and hasattr(tm, name), name
    if module == "data":
        for name in ("HEALTHY", "STALE_INDEX", "UNIFORM_FALLBACK"):
            assert getattr(tm, name) == getattr(jm, name)
    else:
        assert tm.family_names() == jm.family_names()
