"""The port's LGD slice as a whole, against the JAX package.

* optimisers and schedules: the same updates at the golden-pin tolerance;
* the converter: reference states and indexes carried across and back;
* trajectories: a JAX ``init`` state and index converted into the port,
  then 10 ``lgd_step`` (draws rebuilt from the same keys) and 10
  ``sgd_step`` (the same indices) in both packages; theta agrees at
  rtol=1e-4, atol=1e-6 (float32 sums in another order compound over
  steps);
* E[1/(p·N)] = 1 over index builds of the port (statistical);
* the quickstart twin on the CPU: finite losses, LGD loss falls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.optim as JO
import repro.optim.schedules as JSCH
import repro_torch.core as T
import repro_torch.optim as TO
import repro_torch.optim.schedules as TSCH
from _stats import mean_band
from _torch_parity import ATOL, RTOL, jax_sample_draws, n, t
from repro_torch import convert, quickstart
from repro_torch.data import make_classification, make_regression


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(n(got), n(want), rtol=rtol, atol=atol)


class TestOptimizers:
    @pytest.mark.parametrize("name,kw", [
        ("sgd", {}), ("momentum", {}), ("momentum", {"nesterov": True}),
        ("adagrad", {}), ("adam", {}), ("adamw", {})])
    def test_updates_match(self, name, kw):
        rng = np.random.default_rng(0)
        p = rng.standard_normal(7).astype(np.float32)
        jopt, topt = (mod.make_optimizer(name, 0.05, **kw)
                      for mod in (JO, TO))
        js, ts = jopt.init(jnp.asarray(p)), topt.init(t(p))
        jp, tp = jnp.asarray(p), t(p)
        for _ in range(5):
            g = rng.standard_normal(7).astype(np.float32)
            ju, js = jopt.update(jnp.asarray(g), js, jp)
            tu, ts = topt.update(t(g), ts, tp)
            jp, tp = JO.apply_updates(jp, ju), TO.apply_updates(tp, tu)
            _close(tp, jp)
        for got, want in zip(ts, js):
            if want is not None:
                _close(got, want)

    def test_not_ported_names_raise(self):
        assert isinstance(TO.make_optimizer("adam8bit"), TO.Adam8bit)
        assert isinstance(TO.make_optimizer("adafactor"), TO.Adafactor)
        with pytest.raises(ValueError, match="not planned"):
            TO.make_optimizer("optax:adam")
        with pytest.raises(ValueError, match="unknown optimizer"):
            TO.make_optimizer("lion")

    @pytest.mark.parametrize("make", [
        lambda m: m.constant(0.1), lambda m: m.step_decay(0.1, 0.5, 3),
        lambda m: m.exponential_decay(0.1, 0.05),
        lambda m: m.inverse_time_decay(0.1, 0.2),
        lambda m: m.warmup_cosine(0.1, 4, 20, 0.01)])
    def test_schedules_match(self, make):
        js, ts = make(JSCH), make(TSCH)
        for s in (0, 1, 3, 4, 7, 19, 25):
            _close(ts(torch.tensor(s, dtype=torch.int32)),
                   js(jnp.asarray(s, jnp.int32)))

    def test_schedule_drives_optimizer(self):
        opt = TO.SGD(lr=TSCH.step_decay(1.0, 0.5, 1))
        st = opt.init(torch.zeros(2))
        u0, st = opt.update(torch.ones(2), st)
        u1, st = opt.update(torch.ones(2), st)
        np.testing.assert_allclose(n(u0), [-1.0, -1.0])
        np.testing.assert_allclose(n(u1), [-0.5, -0.5])


class TestConvert:
    def test_codes_round_trip(self):
        codes = np.array([[0, 7, 0xFFFFFFFF]], np.uint32)
        got = convert.codes_from_numpy(codes)
        assert got.dtype == torch.int64 and int(got[0, 2]) == 0xFFFFFFFF
        np.testing.assert_array_equal(convert.codes_to_numpy(got), codes)
        with pytest.raises(ValueError):
            convert.codes_to_numpy(torch.tensor([-1]))
        with pytest.raises(TypeError):
            convert.codes_from_numpy(codes.astype(np.int64))

    @pytest.mark.parametrize("name", ["momentum", "adagrad", "adam"])
    def test_opt_state_round_trip(self, name):
        js = JO.make_optimizer(name).init(jnp.arange(3.0))
        ts = convert.opt_state_from_numpy(js)
        assert type(ts).__name__ == type(js).__name__
        back = convert.opt_state_to_numpy(ts)
        for field, want in zip(js._fields, js):
            np.testing.assert_array_equal(back[field], np.asarray(want))


class TestData:
    def test_regression_shapes_and_tail(self):
        g = torch.Generator().manual_seed(0)
        ds = make_regression(g, n_train=3000, n_test=100, d=8, device="cpu")
        assert ds.x_train.shape == (3000, 8) and ds.y_test.shape == (100,)
        assert bool(torch.isfinite(ds.y_train).all())
        # pareto(1.2) residuals: heavy tail far beyond the Gaussian part
        resid = ds.y_train - ds.x_train @ torch.linalg.lstsq(
            ds.x_train, ds.y_train[:, None]).solution[:, 0]
        assert float(resid.abs().max()) > 20 * float(resid.abs().median())
        for noise in ("gauss", "clustered"):
            ds = make_regression(g, n_train=50, n_test=5, d=4, noise=noise,
                                 device="cpu")
            assert ds.x_train.shape == (50, 4)

    def test_classification_labels(self):
        ds = make_classification(torch.Generator().manual_seed(1),
                                 n_train=200, n_test=20, d=5, device="cpu")
        assert set(np.unique(n(ds.y_train)).tolist()) <= {-1.0, 1.0}

    def test_card_requested_without_one(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_regression(torch.Generator(), n_train=5, n_test=1, d=2)


# ---------------------------------------------------------------------------
# the slice as a whole: LGD trajectories in both packages
# ---------------------------------------------------------------------------

def _problem(mod, kind, family, mp, dim):
    return mod.LGDProblem(
        kind=kind, lsh=mod.LSHParams(k=3, l=8, dim=dim, family=family),
        minibatch=8, multiprobe=mp,
        p_floor=1e-6 if family == "mips" else 0.0)


@pytest.mark.parametrize("kind,family,opt_name,mp", [
    ("regression", "quadratic", "sgd", 0),
    ("regression", "srp", "adam", 2),
    ("logistic", "mips", "adagrad", 0),
])
def test_lgd_trajectory_matches_reference(kind, family, opt_name, mp):
    rng = np.random.default_rng(42)
    n_pts, d = 500, 12
    x = (rng.standard_normal((n_pts, d)) *
         rng.uniform(0.5, 2.0, (n_pts, 1))).astype(np.float32)
    y = (x @ rng.standard_normal(d) +
         rng.pareto(1.5, n_pts) * rng.choice([-1, 1], n_pts)).astype(
             np.float32)
    if kind == "logistic":
        y = np.sign(y).astype(np.float32)
    dim = J.get_family(family).aug_dim(d + 1 if kind == "regression" else d)
    jprob = _problem(J, kind, family, mp, dim)
    tprob = _problem(T, kind, family, mp, dim)
    jopt, topt = JO.make_optimizer(opt_name, 0.05), TO.make_optimizer(
        opt_name, 0.05)

    key = jax.random.PRNGKey(7)
    js, jxt, jyt, jxa = J.init(key, jprob, jnp.asarray(x), jnp.asarray(y),
                               jopt)
    ts, txt, tyt, txa = T.init(None, tprob, t(x), t(y), topt,
                               projections=t(js.index.projections))
    for a, b in ((txt, jxt), (tyt, jyt), (txa, jxa)):
        _close(a, b)
    # the converted reference state IS the port's own init state
    conv = convert.lgd_state_from_numpy(js)
    for a, b in zip(conv.index, ts.index):
        np.testing.assert_array_equal(n(a), n(b))
    _close(conv.theta, ts.theta)

    s_lgd_j = s_sgd_j = js
    s_lgd_t = s_sgd_t = conv
    max_probes = max(2 * tprob.lsh.l, 8)
    for step in range(10):
        k = jax.random.fold_in(key, step)
        s_lgd_j, jm = J.lgd_step(k, s_lgd_j, jxt, jyt, jxa, jprob, jopt)
        s_lgd_t, tm = T.lgd_step(
            None, s_lgd_t, txt, tyt, txa, tprob, topt,
            draws=jax_sample_draws(k, tprob.minibatch, max_probes,
                                   tprob.lsh.l, n_pts))
        s_sgd_j, _ = J.sgd_step(k, s_sgd_j, jxt, jyt, jprob, jopt)
        s_sgd_t, _ = T.sgd_step(
            None, s_sgd_t, txt, tyt, tprob, topt,
            indices=t(jax.random.randint(k, (tprob.minibatch,), 0, n_pts),
                      torch.int64))
        _close(tm["sample_prob_mean"], jm["sample_prob_mean"], rtol=1e-4,
               atol=1e-6)
    _close(s_lgd_t.theta, s_lgd_j.theta, rtol=1e-4, atol=1e-6)
    _close(s_sgd_t.theta, s_sgd_j.theta, rtol=1e-4, atol=1e-6)
    assert int(s_lgd_t.step) == int(s_lgd_j.step) == 10
    back = convert.lgd_state_to_numpy(s_lgd_t)
    for field, want in zip(s_lgd_j.opt_state._fields, s_lgd_j.opt_state):
        if want is not None:
            _close(back["opt_state"][field], want, rtol=1e-4, atol=1e-6)
    _close(T.full_loss(s_lgd_t.theta, txt, tyt, tprob),
           J.full_loss(s_lgd_j.theta, jxt, jyt, jprob), rtol=1e-4, atol=1e-6)


def test_query_jitter_and_drain_steps_run():
    """The batched-query and drain variants of lgd_step on the port."""
    g = torch.Generator().manual_seed(3)
    ds = make_regression(g, n_train=300, n_test=10, d=6, device="cpu")
    for extra in ({"query_jitter": 0.05}, {"drain": True}):
        prob = T.LGDProblem(kind="regression", lsh=T.LSHParams(
            k=3, l=8, dim=7, family="dense"), minibatch=4, **extra)
        opt = TO.make_optimizer("sgd", 0.05)
        st, xt, yt, xa = T.init(g, prob, ds.x_train, ds.y_train, opt)
        for _ in range(3):
            st, m = T.lgd_step(g, st, xt, yt, xa, prob, opt)
        assert bool(torch.isfinite(st.theta).all())
        assert 0.0 < float(m["sample_prob_mean"]) <= 1.0


@pytest.mark.statistical
def test_unit_inverse_probability_over_builds():
    """E[1/(p·N)] = 1 for the port's Algorithm-1 samples, expectation
    over index builds and draws — the identity the importance weights
    rest on.  The reference's calibrated MIPS regime
    (tests/test_families.py): n=400, d=6, norms in [2, 4], K=3, L=24,
    24 builds x 1000 draws; buckets essentially always populated."""
    g = torch.Generator().manual_seed(8)
    n_pts, d = 400, 6
    fam = T.get_family("mips")
    dirs = torch.randn((n_pts, d), generator=g)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    x = dirs * (torch.rand((n_pts, 1), generator=g) * 0.5 + 0.5) * 4.0
    x_aug = fam.augment_data(x)
    q = fam.augment_query(torch.randn((d,), generator=g))
    p = T.LSHParams(k=3, l=24, dim=d + 1, family="mips")
    means, mean_l = [], []
    for _ in range(24):
        index = T.mutate_index(None, T.IndexMutation(
            "build", generator=g, x_aug=x_aug), p)
        res = T.sample(g, index, x_aug, q, p, m=1000)
        means.append(float(torch.mean(1.0 / (res.probs * n_pts))))
        mean_l.append(float(res.n_probes.float().mean()))
    assert float(np.mean(mean_l)) < 1.05, "regime drifted"
    means = np.asarray(means)
    # per-build sd ~0.20 (the reference's measurement in this regime)
    band = mean_band(0.20, len(means))
    assert abs(means.mean() - 1.0) < band, (
        f"E[1/(pN)] = {means.mean():.3f} (per-build sd {means.std():.3f})")


def test_quickstart_smoke(capsys):
    """The quickstart twin on the CPU: finite losses and LGD loss falls."""
    hist = quickstart.main(["--steps", "60", "--n-train", "2000",
                            "--device", "cpu"])
    assert len(hist["lgd"]) == 7
    assert all(np.isfinite(hist["lgd"] + hist["sgd"]))
    assert hist["lgd"][-1] < hist["lgd"][0]
    assert "LGD loss" in capsys.readouterr().out
