"""The port's 8-bit Adam, Adafactor and gradient compression against the JAX
package, on the CPU.

Inputs are made with numpy and handed to both packages.  Tolerances:
  * block quantisation (``QTensor``): q, scale and the dequantised
    tensor bitwise (the same f32 ops in the same order);
  * ``Adam8bit``, 5 steps on one tensor: params rtol 1e-5, atol 1e-7
    (the golden-pin tolerance), the int8 moments bitwise;
  * ``Adafactor``, 5 steps (ndim 1, 2 and 3): params rtol 1e-5, atol
    1e-6 (its row and column means sum in another order);
  * compression: the QTensors and the error-feedback residual bitwise
    over 5 steps, ``wire_bytes`` equal;
  * the in-place step: bitwise the functional one;
  * a tiny 1-layer LM through both ``Trainer``s.  Adafactor on the LM
    loss: losses rtol 1e-5, atol 1e-6, params and moments rtol 1e-4,
    atol 1e-6 (as ``test_torch_train.py`` holds Adam).  Adam8bit and
    ``grad_compress`` on a linear loss whose gradients are exact in both
    packages (``_linear``): on the LM loss the two backwards differ in
    the last bits, a quantiser turns an element straddling a rounding
    edge into a one-quantum difference, and Adam8bit's step divides by
    a moment that may quantise to 0, so a trajectory parts within three
    steps in both packages alike.  There: Adam8bit's int8 moments
    equal and params at the golden-pin tolerance; the compressed
    residual at each of 5 steps, the third NaN and skipped with
    its residual unchanged.  Under ``jit`` XLA fuses the reference's
    elementwise chains into FMAs, so Adam8bit's scales agree to rtol 1e-6
    and the residual to atol 1e-6 (an ulp of q·scale), with every int8
    value equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as JM
import repro.optim as JO
import repro.optim.compression as JC
import repro.optim.optimizers as JOO
import repro.train as JT
from _torch_parity import n, t
from repro_torch import convert
from repro_torch.models import ModelConfig
from repro_torch.optim import compression as TC
from repro_torch.optim import make_optimizer, update_in_place
from repro_torch.optim import optimizers as TOO
from repro_torch.train import Trainer, TrainerConfig

TINY = dict(name="tiny", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2,
            d_ff=64, vocab=64, chunk=16, loss_chunk=16, dtype="float32",
            rope_theta=10000.0)
LOSS = dict(rtol=1e-5, atol=1e-6)
PARAMS = dict(rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("shape,block", [((1000,), 256), ((3, 300), 256),
                                         ((256,), 256), ((5,), 256),
                                         ((7, 9), 16)])
def test_blockwise_quantisation_bitwise(shape, block):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x.reshape(-1)[:3] = 0.0
    jq = JOO._quantize_blockwise(jnp.asarray(x), block)
    tq = TOO._quantize_blockwise(t(x), block)
    assert tq.q.dtype == torch.int8 and tq.shape == tuple(shape)
    np.testing.assert_array_equal(n(tq.q), np.asarray(jq.q))
    np.testing.assert_array_equal(n(tq.scale), np.asarray(jq.scale))
    np.testing.assert_array_equal(n(TOO._dequantize_blockwise(tq)),
                                  np.asarray(JOO._dequantize_blockwise(jq)))
    z = TOO._quantized_zeros(shape, block, "cpu")
    jz = JOO._quantize_blockwise(jnp.zeros(shape, jnp.float32), block)
    np.testing.assert_array_equal(n(z.q), np.asarray(jz.q))
    np.testing.assert_array_equal(n(z.scale), np.asarray(jz.scale))


def _five_steps(name, shape, **kw):
    rng = np.random.default_rng(len(shape))
    p = rng.standard_normal(shape).astype(np.float32)
    jopt, topt = (JO.make_optimizer(name, 0.05, **kw),
                  make_optimizer(name, 0.05, **kw))
    js, ts = jopt.init(jnp.asarray(p)), topt.init(t(p))
    jp, tp = jnp.asarray(p), t(p)
    for _ in range(5):
        g = rng.standard_normal(shape).astype(np.float32)
        ju, js = jopt.update(jnp.asarray(g), js, jp)
        tu, ts = topt.update(t(g), ts, tp)
        assert tu.dtype == torch.float32
        jp, tp = JO.apply_updates(jp, ju), TOO.apply_updates(tp, tu)
    return (jp, js), (tp, ts)


@pytest.mark.parametrize("shape", [(7,), (40, 30)])
def test_adam8bit_against_reference(shape):
    (jp, js), (tp, ts) = _five_steps("adam8bit", shape)
    np.testing.assert_allclose(n(tp), np.asarray(jp), rtol=1e-5, atol=1e-7)
    assert int(ts.step) == 5
    for got, want in ((ts.m, js.m), (ts.v, js.v)):
        np.testing.assert_array_equal(n(got.q), np.asarray(want.q))
        np.testing.assert_array_equal(n(got.scale), np.asarray(want.scale))
    back = convert.opt_state_from_numpy(js)
    assert isinstance(back, TOO.Adam8bitState)
    st = convert.opt_state_to_numpy(ts)
    np.testing.assert_array_equal(st["m"][0], n(back.m.q))
    assert st["m"][2] == tuple(shape)


@pytest.mark.parametrize("shape", [(7,), (40, 30), (2, 6, 5)])
def test_adafactor_against_reference(shape):
    (jp, js), (tp, ts) = _five_steps("adafactor", shape)
    np.testing.assert_allclose(n(tp), np.asarray(jp), rtol=1e-5, atol=1e-6)
    for got, want in ((ts.vr, js.vr), (ts.vc, js.vc)):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-12)
    back = convert.opt_state_from_numpy(js)
    assert isinstance(back, TOO.AdafactorState)


@pytest.mark.parametrize("name", ["adam8bit", "adafactor"])
def test_in_place_is_the_functional_step(name):
    rng = np.random.default_rng(5)
    shapes = {"w": (12, 40), "b": (12,)}
    opt = make_optimizer(name, 0.02, **({"block": 64}
                                        if name == "adam8bit" else {}))
    p0 = {k: t(rng.standard_normal(s).astype(np.float32))
          for k, s in shapes.items()}
    pf, pi = ({k: v.clone() for k, v in p0.items()} for _ in range(2))
    sf, si = opt.init(pf), opt.init(pi)
    for _ in range(3):
        g = {k: t(rng.standard_normal(s).astype(np.float32))
             for k, s in shapes.items()}
        u, sf = opt.update(g, sf, pf)
        pf = TOO.apply_updates(pf, u)
        si = update_in_place(opt, pi, g, si)
    for k in shapes:
        assert torch.equal(pf[k], pi[k])
    for a, b in zip(sf[1:], si[1:]):
        for k in shapes:
            x, y = a[k], b[k]
            if isinstance(x, TOO.QTensor):
                assert torch.equal(x.q, y.q) and torch.equal(x.scale,
                                                             y.scale)
            else:
                assert torch.equal(x, y)


def test_compression_against_reference():
    rng = np.random.default_rng(9)
    shapes = {"a": (300,), "b": (17, 5), "c": (512,)}
    jr = JC.init_error_feedback({k: jnp.zeros(s) for k, s in shapes.items()})
    tr = TC.init_error_feedback({k: torch.zeros(s) for k, s in
                                 shapes.items()})
    for _ in range(5):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        jq, jr = JC.compress_with_feedback(
            {k: jnp.asarray(v) for k, v in g.items()}, jr)
        tq, tr = TC.compress_with_feedback({k: t(v) for k, v in g.items()},
                                           tr)
        for k in shapes:
            np.testing.assert_array_equal(n(tq[k].q), np.asarray(jq[k].q))
            np.testing.assert_array_equal(n(tr[k]), np.asarray(jr[k]))
        assert TC.wire_bytes(tq) == JC.wire_bytes(jq)
        jd = JC.decompress(jq)
        for k, v in TC.decompress(tq).items():
            np.testing.assert_array_equal(n(v), np.asarray(jd[k]))
    like = {k: torch.zeros(s, dtype=torch.bfloat16)
            for k, s in shapes.items()}
    assert all(v.dtype == torch.bfloat16
               for v in TC.decompress(tq, like=like).values())
    one = TC.compress(t(g["b"]))
    np.testing.assert_array_equal(
        n(one.q), np.asarray(JC.compress(jnp.asarray(g["b"])).q))


# ---------------------------------------------------------------------------
# a tiny LM through both trainers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    cfg, jcfg = ModelConfig(**TINY), JM.ModelConfig(**TINY)
    params = jax.jit(JM.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(40)
    batches = []
    for _ in range(5):
        rows = rng.integers(0, cfg.vocab, (4, 17)).astype(np.int32)
        batches.append({"tokens": rows[:, :-1], "targets": rows[:, 1:],
                        "loss_weights": rng.uniform(0.5, 2.0, 4).astype(
                            np.float32)})
    return cfg, jcfg, params, batches


def _both(tiny, jopt, topt, batches=None, loss_fns=(None, None), **tkw):
    cfg, jcfg, params, default = tiny
    batches = batches or default
    jt = JT.Trainer(jcfg, params, jopt,
                    iter([{k: jnp.asarray(v) for k, v in b.items()}
                          for b in batches]),
                    JT.TrainerConfig(log_every=1, donate=False, **tkw),
                    resume=False, loss_fn=loss_fns[0])
    lm = convert.lm_params_from_numpy(params, cfg, "cpu")
    tt = Trainer(cfg, lm, topt, iter([{k: t(v) for k, v in b.items()}
                                      for b in batches]),
                 TrainerConfig(log_every=1, **tkw), loss_fn=loss_fns[1])
    return jt, tt, lm


def _linear(tiny, nan_step=None):
    """Loss functions sum(p * C_i) over every parameter, with C_i a
    seeded coefficient tree for step i (NaN at ``nan_step``): their
    gradients are C_i exactly in both packages, so what follows the
    backward (compression, the moments' quantisation) sees bitwise the
    same inputs, free of the summation-order noise that a quantiser's
    rounding edges would amplify."""
    cfg, _, params, _ = tiny
    rng = np.random.default_rng(50)
    coef = jax.tree.map(lambda p: rng.standard_normal(
        (5,) + p.shape).astype(np.float32), params)
    if nan_step is not None:
        coef = jax.tree.map(lambda c: c.copy(), coef)
        for c in jax.tree.leaves(coef):
            c[nan_step] = np.nan
    lm = convert.lm_params_from_numpy(params, cfg, "cpu")
    per_step = [convert.lm_tree_from_numpy(
        jax.tree.map(lambda c, i=i: c[i], coef), lm) for i in range(5)]

    coef_j = jax.tree.map(jnp.asarray, coef)

    def ref_loss(p, b):
        return sum(jnp.sum(x * c[b["i"]]) for x, c in
                   zip(jax.tree.leaves(p), jax.tree.leaves(coef_j)))

    def port_loss(model, b):
        c = per_step[int(b["i"])]
        return sum((x * c[k]).sum() for k, x in model.named_parameters())

    batches = [{"i": np.int32(i)} for i in range(5)]
    return batches, (ref_loss, port_loss)


def _close_params(lm, jt, **tol):
    got = convert.lm_params_to_numpy(lm)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(jt.params)):
        np.testing.assert_allclose(g, np.asarray(w), **(tol or PARAMS),
                                   err_msg=jax.tree_util.keystr(path))


def test_lm_adam8bit_trainer_against_reference(tiny):
    """5 Adam8bit steps through both trainers on the same gradients (the
    linear loss, no clip): params at the golden-pin tolerance and every
    int8 moment, mapped through ``convert`` both ways, bitwise."""
    cfg = tiny[0]
    batches, fns = _linear(tiny)
    jt, tt, lm = _both(tiny, JO.Adam8bit(lr=1e-2),
                       make_optimizer("adam8bit", 1e-2), batches=batches,
                       loss_fns=fns, grad_clip=None)
    jt.run(5)
    tt.run(5)
    _close_params(lm, jt, rtol=1e-5, atol=1e-7)
    back = convert.adam8bit_state_from_numpy(jt.opt_state, lm)
    for field in ("m", "v"):
        for k, qt in getattr(tt.opt_state, field).items():
            ref = getattr(back, field)[k]
            assert torch.equal(qt.q, ref.q) and qt.shape == ref.shape, k
            # XLA fuses the jitted moment update (FMA): scales part in
            # the last bits
            torch.testing.assert_close(qt.scale, ref.scale, rtol=1e-6,
                                       atol=0)
    # the reference's state through the port's layout and back: bitwise
    there = convert.adam8bit_state_to_numpy(back, cfg)
    flat_j = jax.tree_util.tree_leaves(
        jt.opt_state.m, is_leaf=lambda x: isinstance(x, JOO.QTensor))
    flat_t = jax.tree_util.tree_leaves(
        there["m"], is_leaf=lambda x: isinstance(x, tuple))
    assert len(flat_t) == len(flat_j)
    for (q, scale, shape), ref in zip(flat_t, flat_j):
        np.testing.assert_array_equal(q, np.asarray(ref.q))
        np.testing.assert_array_equal(scale, np.asarray(ref.scale))
        assert tuple(shape) == tuple(ref.shape)


def test_lm_adam8bit_state_needs_whole_blocks_per_layer(tiny):
    """Two layers whose 32-value norm scales share one stacked block in
    the reference: the map raises instead of splitting a block."""
    cfg2 = ModelConfig(**{**TINY, "n_layers": 2})
    jcfg2 = JM.ModelConfig(**{**TINY, "n_layers": 2})
    params = jax.jit(JM.init_params, static_argnums=1)(
        jax.random.PRNGKey(1), jcfg2)
    lm = convert.lm_params_from_numpy(params, cfg2, "cpu")
    st = JO.Adam8bit().init(params)
    with pytest.raises(ValueError, match="shares blocks between layers"):
        convert.adam8bit_state_from_numpy(st, lm)


def test_lm_adafactor_trainer_against_reference(tiny):
    cfg = tiny[0]
    jt, tt, lm = _both(tiny, JO.Adafactor(lr=1e-2),
                       make_optimizer("adafactor", 1e-2))
    np.testing.assert_allclose(tt.run(5)["losses"], jt.run(5)["losses"],
                               **LOSS)
    _close_params(lm, jt)
    back = convert.adafactor_state_from_numpy(jt.opt_state, lm)
    for k in tt.opt_state.vr:
        for got, want in ((tt.opt_state.vr[k], back.vr[k]),
                          (tt.opt_state.vc[k], back.vc[k])):
            assert got.shape == want.shape, k
            np.testing.assert_allclose(n(got), n(want), rtol=1e-4,
                                       atol=1e-12, err_msg=k)
    there = convert.adafactor_state_to_numpy(tt.opt_state, cfg)
    for field in ("vr", "vc"):
        for (path, g), w in zip(
                jax.tree_util.tree_leaves_with_path(there[field]),
                jax.tree_util.tree_leaves(getattr(jt.opt_state, field))):
            assert g.shape == np.asarray(w).shape
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4,
                                       atol=1e-12,
                                       err_msg=jax.tree_util.keystr(path))


def test_lm_grad_compress_against_reference(tiny):
    """5 compressed steps on the same gradients (the linear loss), the
    third NaN: the residual is the reference's at every step (atol 1e-6),
    the skipped step leaves it bitwise as it was, and the params follow
    the reference's (rtol 1e-4: the clip's global norm sums in another
    order)."""
    cfg = tiny[0]
    batches, fns = _linear(tiny, nan_step=2)
    jt, tt, lm = _both(tiny, JO.Adam(lr=1e-2), make_optimizer("adam", 1e-2),
                       batches=batches, loss_fns=fns, grad_compress=True)
    for i in range(5):
        before = {k: v.clone() for k, v in tt._ef_residual.items()}
        jt.run(1)
        tt.run(1)
        if i == 2:
            for k, v in tt._ef_residual.items():
                assert torch.equal(v, before[k]), k
        mine = convert.lm_tree_to_numpy(tt._ef_residual, cfg)
        for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(mine),
                                jax.tree_util.tree_leaves(jt._ef_residual)):
            # XLA fuses corrected - q * scale into one FMA: an ulp of
            # q * scale (4.8e-7 at |g| ~ 4); a q one apart would differ
            # by a whole scale (~0.03)
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-6,
                                       err_msg=jax.tree_util.keystr(path))
    assert jt.skipped_steps == tt.skipped_steps == 1
    assert not any(bool(v.abs().sum() == 0) for v in before.values())
    _close_params(lm, jt)


def test_adam8bit_zero_gradient_jump():
    """The reference's Adam8bit, and the port with it: in a block whose
    largest gradient is 100x an element's, that element's stored v
    rounds to 0 (below 1/254 of the block's largest) while its m does
    not (1/100 of the largest, above 1/254); a later step with g = 0
    there divides b1·m̂ by sqrt(0) + eps, a step of lr·b1·m̂/1e-8 where
    Adam moves by about lr."""
    g1 = np.zeros(256, np.float32)
    g1[0], g1[1] = 1.0, 0.01
    p = np.zeros(256, np.float32)
    jumps = []
    for mod, arr, opt in ((JO, jnp.asarray, JO.Adam8bit(lr=1e-3)),
                          (TOO, t, make_optimizer("adam8bit", 1e-3))):
        st = opt.init(arr(p))
        _, st = opt.update(arr(g1), st, arr(p))
        assert int(np.asarray(n(st.v.q) if mod is TOO else st.v.q)[0, 1]) \
            == 0
        u, _ = opt.update(arr(np.zeros(256, np.float32)), st, arr(p))
        jumps.append(float(np.asarray(n(u) if mod is TOO else u)[1]))
    np.testing.assert_allclose(jumps[1], jumps[0], rtol=1e-6)
    assert abs(jumps[1]) > 1e3 * 1e-3      # a thousand Adam steps at once
