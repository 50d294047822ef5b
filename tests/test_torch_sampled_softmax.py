"""The port's LSH-sampled softmax head against the JAX package, on the CPU.

Inputs are numpy seeds or the reference's own parameters carried over
with ``repro_torch.convert``; the port samples with the reference's
draws (``tests/_torch_parity.py``) where a draw is compared.  Tolerances:

* ``sampled_head_xent`` values and its ``lm_head`` / query gradients:
  rtol 1e-5, atol 1e-6 (f32, another summation order);
* ``LMHeadIndex``: the pinned scale at rtol 1e-6, ``x_aug`` at 1e-6 (its
  Simple-LSH tail as tail^2: a band's max-norm row magnifies a last-bit
  difference of |x/M|^2 there), the index bitwise after the build and
  after a full and a delta refresh; the ``_dirty_ids`` drift draw equal;
* ``shortlist_candidates`` ids / valid bitwise on the same index,
  ``shortlist_logits`` at rtol 1e-5 (the port casts gathered bf16/f32
  rows, the reference the whole head: the same values, another sum
  order); ``lsh_decode_step`` tokens equal on a converted SMOKE LM;
* the sampled loss with the reference's draws at rtol 1e-5.

And the reference's statistical guards with the port's own draws:
E[Zhat] = Z over index builds (tests/test_sampled_softmax.py:61) and
the banded shortlist's recall@1 >= 0.9 (:219).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as JM
import repro.models.sampled_softmax as JSS
from _stats import mean_band
from _torch_parity import ATOL, RTOL, jax_sample_draws, n, t
from repro import configs as jconfigs
from repro.core.families import get_family as j_family
from repro_torch import configs, convert
from repro_torch.core import IndexMutation, LSHParams, get_family, \
    mutate_index, sample_batched
from repro_torch.models import (LMHeadIndex, SampledSoftmaxConfig,
                                lsh_decode_step, make_sampled_loss,
                                sampled_softmax_loss)
from repro_torch.models.sampled_softmax import (
    _SALT_HEAD_STEP, sampled_head_xent, shortlist_candidates,
    shortlist_logits)
from repro_torch.optim import make_optimizer
from repro_torch.train import Trainer, TrainerConfig

ARCH = "phi4_mini_3_8b"
GRAD = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def smoke():
    """(reference config, its params, the port's LM on the same weights)."""
    jcfg = jconfigs.get_smoke(ARCH).with_(attn_impl="ref")
    params = JM.init_params(jax.random.PRNGKey(0), jcfg)
    lm = convert.lm_params_from_numpy(params, configs.get_smoke(ARCH), "cpu")
    return jcfg, params, lm


def _configs(**kw):
    return (JSS.SampledSoftmaxConfig(use_pallas=False, **kw),
            SampledSoftmaxConfig(**kw))


def _heads(smoke, **kw):
    """The reference's head index and the port's, built on the
    reference's projections."""
    jcfg, params, lm = smoke
    jsc, tsc = _configs(**kw)
    jh = JSS.LMHeadIndex(params, jcfg, jsc)
    th = LMHeadIndex(lm, tsc, projections=t(jh.index.projections))
    return jh, th


def _assert_heads_equal(th, jh):
    scale = th.scale if isinstance(th.scale, tuple) else (th.scale,)
    jscale = jh.scale if isinstance(jh.scale, tuple) else (jh.scale,)
    for a, b in zip(scale, jscale):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-6)
    xg, xj = n(th.x_aug), np.asarray(jh.x_aug)
    tail = xg.shape[1] - (2 if th._fam.num_bands() > 1 else 1)
    body = [c for c in range(xg.shape[1]) if c != tail]
    np.testing.assert_allclose(xg[:, body], xj[:, body], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(xg[:, tail] ** 2, xj[:, tail] ** 2, rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(convert.codes_to_numpy(
        th.index.sorted_codes), np.asarray(jh.index.sorted_codes))
    np.testing.assert_array_equal(n(th.index.order),
                                  np.asarray(jh.index.order))


# -- the head-level sampled cross entropy ---------------------------------------

def test_sampled_head_xent_and_grads():
    rng = np.random.default_rng(2)
    d, v, tt, m = 16, 40, 6, 5
    q = rng.standard_normal((tt, d)).astype(np.float32)
    head = (0.3 * rng.standard_normal((d, v))).astype(np.float32)
    targets = rng.integers(0, v, tt)
    neg = rng.integers(0, v, (tt, m))
    probs = rng.uniform(0.01, 0.2, (tt, m)).astype(np.float32)
    probs[0, 0] = 1e-12                                  # below p_floor

    def j_loss(q_, h_):
        return jnp.sum(JSS.sampled_head_xent(q_, h_, targets, neg, probs))

    want = JSS.sampled_head_xent(q, head, targets, neg, probs)
    jg_q, jg_h = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(q),
                                                  jnp.asarray(head))
    tq = t(q).requires_grad_()
    th = t(head).requires_grad_()
    got = sampled_head_xent(tq, th, t(targets), t(neg), t(probs))
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=RTOL)
    got.sum().backward()
    np.testing.assert_allclose(n(tq.grad), np.asarray(jg_q), **GRAD)
    np.testing.assert_allclose(n(th.grad), np.asarray(jg_h), **GRAD)


def test_gradient_only_touches_sampled_columns():
    rng = np.random.default_rng(3)
    d, v = 8, 64
    head = t((0.3 * rng.standard_normal((d, v))).astype(np.float32))
    head.requires_grad_()
    targets = torch.tensor([3, 7])
    neg = torch.tensor([[1, 2, 3, 4], [10, 11, 12, 13]])
    probs = torch.full((2, 4), 0.05).requires_grad_()
    sampled_head_xent(t(rng.standard_normal((2, d)).astype(np.float32)),
                      head, targets, neg, probs).sum().backward()
    touched = np.unique(np.concatenate([n(targets), n(neg).ravel()]))
    untouched = np.setdiff1d(np.arange(v), touched)
    assert (n(head.grad)[:, untouched] == 0).all()
    assert (n(head.grad)[:, touched] != 0).any()
    assert probs.grad is None                    # the probabilities detach


def test_sampled_loss_matches_the_reference(smoke):
    """``sampled_softmax_loss`` with the reference's draws (its per-step
    key) on the same weights and index: the loss at rtol 1e-5."""
    jcfg, params, lm = smoke
    jh, th = _heads(smoke, k=3, l=6, n_samples=16, multiprobe=1)
    toks = np.random.default_rng(4).integers(0, jcfg.vocab, (2, 9))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    jb = jh.inject({k: jnp.asarray(v) for k, v in batch.items()}, step=3)
    want = float(JSS.sampled_softmax_loss(params, jcfg, jh.scfg, jb))
    draws = jax_sample_draws(jb["head_key"], 16, max(2 * 6, 8), 6,
                             jcfg.vocab, batch=2 * 8)
    tb = th.inject({k: t(v) for k, v in batch.items()}, step=3)
    tb["head_draws"] = draws
    with torch.no_grad():
        got = float(sampled_softmax_loss(lm, lm.cfg, th.scfg, tb))
    np.testing.assert_allclose(got, want, rtol=RTOL)


# -- the index over the head -------------------------------------------------------

@pytest.mark.parametrize("family", ["mips", "mips_banded"])
def test_head_index_build_and_refreshes(smoke, family):
    """The build, then a delta refresh of noted targets plus the drift
    draw, then a full refresh, on both sides after the same head update:
    the drift ids equal and every index bitwise."""
    jcfg, params, lm = smoke
    # copies: the head moves below, and the fixture is the module's
    params = jax.tree.map(lambda a: a, params)
    params["embed_group"] = dict(params["embed_group"])
    lm = convert.lm_params_from_numpy(convert.lm_params_to_numpy(lm),
                                      lm.cfg, "cpu")
    jh, th = _heads((jcfg, params, lm), family=family, k=3, l=8,
                    drift_sample=0.1)
    _assert_heads_equal(th, jh)
    rng = np.random.default_rng(5)
    head = np.asarray(params["embed_group"]["lm_head"])
    for mode in ("delta", "full"):
        head = head + 0.05 * rng.standard_normal(head.shape).astype(
            np.float32)
        params["embed_group"]["lm_head"] = jnp.asarray(head)
        with torch.no_grad():
            lm.embed_group.lm_head.copy_(t(head))
        targets = rng.integers(0, jcfg.vocab, 12)
        jh.note_targets(targets)
        th.note_targets(t(targets))
        if mode == "delta":
            np.testing.assert_array_equal(th._dirty_ids(), jh._dirty_ids())
        jh.refresh(params, mode=mode)
        th.refresh(lm, mode=mode)
        _assert_heads_equal(th, jh)
    assert th.refreshes == 2 and th.delta_refreshes == th.full_refreshes == 1
    np.testing.assert_array_equal(n(th.rows), head.T)


def test_delta_all_dirty_equals_full_warm_refresh(smoke):
    lm = convert.lm_params_from_numpy(convert.lm_params_to_numpy(smoke[2]),
                                      smoke[2].cfg, "cpu")
    scfg = SampledSoftmaxConfig(k=3, l=4, drift_sample=0.0)
    a, b = LMHeadIndex(lm, scfg), LMHeadIndex(lm, scfg)
    with torch.no_grad():
        lm.embed_group.lm_head.add_(0.01 * torch.randn(
            lm.embed_group.lm_head.shape,
            generator=torch.Generator().manual_seed(50)))
    a.note_targets(np.arange(lm.cfg.vocab))
    a.refresh(lm, mode="delta")
    b.refresh(lm, mode="full", repin_scale=False)
    assert torch.equal(a.index.sorted_codes, b.index.sorted_codes)
    assert torch.equal(a.index.order, b.index.order)
    assert torch.equal(a.x_aug, b.x_aug)


def test_refresh_cadence(smoke):
    _, _, lm = smoke
    head = LMHeadIndex(lm, SampledSoftmaxConfig(
        k=3, l=4, refresh_every=10, refresh_mode="delta", full_every=3,
        drift_sample=0.0))
    fired = [head.maybe_refresh(s, lm) for s in range(1, 61)]
    assert sum(fired) == 6 and not any(fired[:9])
    assert head.delta_refreshes == 4 and head.full_refreshes == 2


def test_trainer_with_the_sampled_loss(smoke):
    """5 ``Trainer`` steps with the sampled loss, the batches through
    ``wrap_batches`` and the refresh cadence driven by the loop
    (``maybe_refresh`` after each step: the port's trainer has no step
    hook yet): finite losses, the head moves, the cadence fires, and the
    exact loss still evaluates."""
    _, _, lm0 = smoke
    lm = convert.lm_params_from_numpy(convert.lm_params_to_numpy(lm0),
                                      lm0.cfg, "cpu")
    scfg = SampledSoftmaxConfig(k=3, l=4, n_samples=16, multiprobe=1,
                                refresh_every=2, refresh_mode="delta")
    head = LMHeadIndex(lm, scfg)

    def batches():
        rng = np.random.default_rng(60)
        while True:
            toks = t(rng.integers(0, lm.cfg.vocab, (2, 17)))
            yield {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    tr = Trainer(lm.cfg, lm, make_optimizer("sgd", lambda s: 1e-2),
                 head.wrap_batches(batches()), TrainerConfig(log_every=100),
                 loss_fn=make_sampled_loss(lm.cfg, scfg))
    before = lm.embed_group.lm_head.detach().clone()
    losses = []
    for _ in range(5):
        losses += tr.run(1)["losses"]
        head.maybe_refresh(tr.step, lm)
    assert len(losses) == 5 and all(np.isfinite(losses)) and tr.step == 5
    assert head.refreshes == 2
    assert not torch.equal(before, lm.embed_group.lm_head)
    toks = t(np.random.default_rng(61).integers(0, lm.cfg.vocab, (2, 17)))
    with torch.no_grad():
        assert np.isfinite(float(lm.loss({"tokens": toks[:, :-1],
                                          "targets": toks[:, 1:]})))


def test_sampled_loss_tracks_the_full_loss(smoke):
    _, _, lm = smoke
    scfg = SampledSoftmaxConfig(k=3, l=8, n_samples=64, multiprobe=1)
    head = LMHeadIndex(lm, scfg)
    toks = t(np.random.default_rng(70).integers(0, lm.cfg.vocab, (4, 17)))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    with torch.no_grad():
        ls = float(sampled_softmax_loss(lm, lm.cfg, scfg,
                                        head.inject(batch, step=0)))
        lf = float(lm.loss(batch))
    assert abs(ls - lf) / lf < 0.2, (ls, lf)


def test_step_streams_are_seeded():
    """The per-step generator depends on (seed, step) only, with the
    reference's salt keeping it apart from the build stream."""
    from repro_torch.models.sampled_softmax import _generator

    a = torch.rand(4, generator=_generator("cpu", 0, _SALT_HEAD_STEP, 3))
    b = torch.rand(4, generator=_generator("cpu", 0, _SALT_HEAD_STEP, 3))
    c = torch.rand(4, generator=_generator("cpu", 0, _SALT_HEAD_STEP, 4))
    assert torch.equal(a, b) and not torch.equal(a, c)


# -- the shortlist and the decode step ---------------------------------------------

@pytest.mark.parametrize("family,mp", [("mips", 0), ("mips", 2),
                                       ("mips_banded", 2)])
def test_shortlist_matches_the_reference(smoke, family, mp):
    jcfg, params, lm = smoke
    jh, th = _heads(smoke, family=family, k=3, l=8, multiprobe=mp,
                    shortlist_per_table=8)
    q = np.random.default_rng(8).standard_normal((3, jcfg.d_model)).astype(
        np.float32)
    qa = j_family(family).augment_query(jnp.asarray(q))
    lsh = JSS.head_lsh_params(jcfg, jh.scfg)
    ids_j, valid_j = JSS.shortlist_candidates(jh.index, qa, lsh, jh.scfg)
    ids_t, valid_t = shortlist_candidates(th.index, t(qa), th.lsh, th.scfg)
    np.testing.assert_array_equal(n(ids_t), np.asarray(ids_j))
    np.testing.assert_array_equal(n(valid_t), np.asarray(valid_j))
    want = JSS.shortlist_logits(params["embed_group"]["lm_head"], q, ids_j,
                                valid_j)
    for rows in (th.rows, lm.embed_group.lm_head.T):
        got = shortlist_logits(rows, t(q), ids_t, valid_t)
        assert torch.equal(torch.isinf(got), ~valid_t)
        np.testing.assert_allclose(n(got), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


def test_lsh_decode_step_matches_the_reference(smoke):
    """Prefill 8 tokens, then 4 steps fed the reference's tokens: every
    ``lsh_decode_step`` token equal, on the same banded index, put on the
    port's side with ``convert.lm_head_index_from_numpy`` (the scale,
    x_aug and index of the reference's ``LMHeadIndex``)."""
    jcfg, params, lm = smoke
    jsc, tsc = _configs(family="mips_banded", k=3, l=8, multiprobe=2,
                        shortlist_per_table=8)
    jh = JSS.LMHeadIndex(params, jcfg, jsc)
    th = convert.lm_head_index_from_numpy(
        LMHeadIndex(lm, tsc), tuple(jh.scale), jh.x_aug, jh.index)
    for got, want in zip(convert.banded_scale_to_numpy(th.scale), jh.scale):
        np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(n(th.x_aug), np.asarray(jh.x_aug))
    np.testing.assert_array_equal(convert.codes_to_numpy(
        th.index.sorted_codes), np.asarray(jh.index.sorted_codes))
    toks = np.random.default_rng(9).integers(0, jcfg.vocab, (2, 8))
    jcache = JM.init_cache(jcfg, 2, 16)
    _, jcache = JM.prefill(params, jcfg, {"tokens": jnp.asarray(toks)},
                           jcache)
    cache = lm.init_cache(2, 16)
    _, cache = lm.prefill({"tokens": t(toks)}, cache)
    tok_j = jnp.asarray(toks[:, -1:])
    for i in range(4):
        pos = 8 + i
        step_j = {"tokens": tok_j,
                  "positions": jnp.full((2, 1), pos, jnp.int32)}
        step_t = {"tokens": t(np.asarray(tok_j)),
                  "positions": torch.full((2, 1), pos, dtype=torch.int32)}
        tok_j, jcache = JM.lsh_decode_step(params, jcfg, jh.scfg, step_j,
                                           jcache, jh.index)
        tok_t, cache = lsh_decode_step(lm, step_t, cache, th)
        assert tok_t.shape == (2, 1)
        np.testing.assert_array_equal(n(tok_t), np.asarray(tok_j),
                                      err_msg=f"step {i}")


def test_shortlist_masks_out_of_bucket_slots():
    rng = np.random.default_rng(40)
    rows = (0.25 * rng.standard_normal((64, 16))).astype(np.float32)
    fam = get_family("mips")
    xa = fam.augment_data(t(rows), scale=fam.data_scale(t(rows)))
    scfg = SampledSoftmaxConfig(k=5, l=4, multiprobe=1,
                                shortlist_per_table=16)
    p = LSHParams(k=5, l=4, dim=17, family="mips")
    idx = mutate_index(None, IndexMutation(
        "build", generator=torch.Generator().manual_seed(40), x_aug=xa), p)
    q = t(rng.standard_normal((3, 16)).astype(np.float32))
    ids, valid = shortlist_candidates(idx, fam.augment_query(q), p, scfg)
    logits = shortlist_logits(t(rows), q, ids, valid)
    assert bool((logits[~valid] == float("-inf")).all())
    assert bool(torch.isfinite(logits[valid]).all())
    assert bool(valid.any(-1).all())


# -- the statistical guards, with the port's own draws ------------------------------

@pytest.mark.statistical
def test_zhat_unbiased_over_index_builds():
    """E[Zhat] = Z over index builds and draws (the reference's
    tests/test_sampled_softmax.py:61: V 512, d 32, K 3, L 8, 40 builds
    of m 64, 4 queries, the mips family in its populated-bucket regime).
    The band is the reference's: 3 sigma of a 0.6 per-trial sd, plus
    0.05 for the family's calibration residual.  Measured with the
    port's draws: E[Zhat]/Z = 0.9439 / 1.0374 / 0.9436 / 1.1420 (per-trial
    sd 0.34-0.52), mean probes 1.0305."""
    rng = np.random.default_rng(0)
    v, d = 512, 32
    rows = t((0.25 * rng.standard_normal((v, d))).astype(np.float32))
    fam = get_family("mips")
    xa = fam.augment_data(rows, scale=fam.data_scale(rows))
    p = LSHParams(k=3, l=8, dim=fam.aug_dim(d), family="mips")
    q = t(rng.standard_normal((4, d)).astype(np.float32))
    qa = fam.augment_query(q)
    logits = (q.double() @ rows.double().T)                 # (4, V)
    z = logits.exp().sum(-1)
    builds, m = 40, 64
    trials, probes = [], []
    for b in range(builds):
        g = torch.Generator().manual_seed(7000 + b)
        idx = mutate_index(None, IndexMutation("build", generator=g,
                                               x_aug=xa), p)
        res = sample_batched(g, idx, xa, qa, p, m=m)
        l_neg = torch.gather(logits, 1, res.indices)
        trials.append((l_neg.exp() / res.probs.double()).mean(-1) / z)
        probes.append(float(res.n_probes.float().mean()))
    assert np.mean(probes) < 1.1, f"regime drifted: {np.mean(probes)}"
    grand = torch.stack(trials).mean(0).numpy()
    band = mean_band(0.6, builds) + 0.05
    assert np.all(np.abs(grand - 1.0) < band), grand


@pytest.mark.statistical
def test_banded_shortlist_recall():
    """recall@1 of the banded shortlist >= 0.9 on an un-normalised head
    with planted winners (the reference's tests/test_sampled_softmax.py
    :219: V 512, d 32, rows 0.3 N(0, 1), queries = 64 head rows + 0.1 ·
    0.3 noise, K 5, L 8, multiprobe 2, 8 a bucket).  Measured with the
    port's projections: 1.0."""
    rng = np.random.default_rng(50)
    v, d = 512, 32
    rows = t((0.3 * rng.standard_normal((v, d))).astype(np.float32))
    winners = t(rng.integers(0, v, 64))
    q = rows[winners] + 0.03 * t(rng.standard_normal((64, d)).astype(
        np.float32))
    true = (q @ rows.T).argmax(-1)
    fam = get_family("mips_banded")
    xa = fam.augment_data(rows, scale=fam.data_scale(rows))
    scfg = SampledSoftmaxConfig(family="mips_banded", k=5, l=8,
                                multiprobe=2, shortlist_per_table=8)
    p = LSHParams(k=5, l=8, dim=fam.aug_dim(d), family="mips_banded")
    idx = mutate_index(None, IndexMutation(
        "build", generator=torch.Generator().manual_seed(53), x_aug=xa), p)
    ids, valid = shortlist_candidates(idx, fam.augment_query(q), p, scfg)
    got = torch.gather(ids, 1, shortlist_logits(rows, q, ids, valid)
                       .argmax(-1)[:, None])[:, 0]
    recall = float((got == true).float().mean())
    assert recall >= 0.9, f"banded shortlist recall@1 {recall}"
