"""Parity of the port's sequence mixers (``repro_torch.models.ssm``) with
the JAX package's (``repro.models.ssm``), on the CPU.

Inputs come from numpy seeds; the reference's parameters (with the f32
constants ``a_log``, ``dt_bias``, ``d_skip`` and ``gate_bias`` drawn at
random, so that a misplaced constant shows) are copied into the port's
modules.  Tolerances, f32:
  * the chunked core and the decode step: rtol = atol = 1e-5, the same
    arithmetic in another summation order;
  * a block (norm, projections, core, output): rtol = atol = 2e-5;
  * sLSTM at S 2,048: rtol = atol = 1e-5 (the doubling scan and
    ``lax.associative_scan`` combine the same segments in other trees;
    measured ~1e-6), and the stabiliser m within 1e-5 of a float64 step
    loop, where a closed form (a cumsum differenced) parts by ~2e-4;
  * prefill of a chunked prompt, then decode, against ``forward``: 2e-3,
    the reference's own tolerance (tests/test_models.py).
"""

import jax
import numpy as np
import pytest
import torch

from _torch_parity import n, t
from repro.models import ssm as jssm
from repro.models.config import ModelConfig as JConfig
from repro_torch import configs
from repro_torch.models import LM, ModelConfig
from repro_torch.models import ssm

CORE = dict(rtol=1e-5, atol=1e-5)
BLOCK = dict(rtol=2e-5, atol=2e-5)
LONG = dict(rtol=1e-5, atol=1e-5)
DECODE = dict(rtol=2e-3, atol=2e-3)


def _core_inputs(seed, b=2, s=17, h=3, nn=8, p=4):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((b, s, h, nn)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, s, h, p)).astype(np.float32)
    log_a = -np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(
        np.float32)
    state0 = rng.standard_normal((b, h, nn, p)).astype(np.float32)
    return q, k, v, log_a, state0


class TestGLACore:
    @pytest.mark.parametrize("with_state", [False, True])
    @pytest.mark.parametrize("chunk", [8, 16])
    @pytest.mark.parametrize("s", [17, 64, 256])
    def test_chunked_matches_reference(self, s, chunk, with_state):
        q, k, v, log_a, state0 = _core_inputs(s + chunk, s=s)
        st = state0 if with_state else None
        y, state = ssm.gla_chunked(t(q), t(k), t(v), t(log_a), chunk,
                                   None if st is None else t(st))
        jy, jstate = jssm.gla_chunked(q, k, v, log_a, chunk, st)
        np.testing.assert_allclose(n(y), np.asarray(jy), **CORE)
        np.testing.assert_allclose(n(state), np.asarray(jstate), **CORE)

    @pytest.mark.parametrize("s,chunk", [(16, 4), (23, 8), (32, 32)])
    def test_chunked_equals_naive_recurrence(self, s, chunk):
        """Inside the port: the chunked core equals the step recurrence."""
        q, k, v, log_a, _ = _core_inputs(s, s=s)
        q, k, v, log_a = t(q), t(k), t(v), t(log_a)
        y, state = ssm.gla_chunked(q, k, v, log_a, chunk)
        st = torch.zeros(2, 3, 8, 4)
        ys = []
        for i in range(s):
            yi, st = ssm.gla_decode_step(q[:, i], k[:, i], v[:, i],
                                         log_a[:, i], st)
            ys.append(yi)
        torch.testing.assert_close(y, torch.stack(ys, dim=1), rtol=1e-4,
                                   atol=1e-4)
        torch.testing.assert_close(state, st, rtol=1e-4, atol=1e-4)

    def test_decode_step_matches_reference(self):
        q, k, v, log_a, state0 = _core_inputs(3, s=1)
        y, st = ssm.gla_decode_step(t(q[:, 0]), t(k[:, 0]), t(v[:, 0]),
                                    t(log_a[:, 0]), t(state0))
        jy, jst = jssm.gla_decode_step(q[:, 0], k[:, 0], v[:, 0],
                                       log_a[:, 0], state0)
        np.testing.assert_allclose(n(y), np.asarray(jy), **CORE)
        np.testing.assert_allclose(n(st), np.asarray(jst), **CORE)

    def test_masked_exponent_keeps_gradients_finite(self):
        """A decay whose above-diagonal ratio overflows f32 (exp(64 *
        3)): the masked-exponent form keeps the backward finite."""
        q, k, v, _, _ = _core_inputs(4, s=64)
        q, k, v = (t(a).requires_grad_() for a in (q, k, v))
        log_a = torch.full((2, 64, 3), -3.0)
        y, _ = ssm.gla_chunked(q, k, v, log_a, 64)
        y.sum().backward()
        assert all(bool(torch.isfinite(a.grad).all()) for a in (q, k, v))


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

def _cfg(**kw):
    base = dict(name="mix", n_layers=1, d_model=32, n_heads=4, n_kv_heads=4,
                d_ff=0, vocab=64, ssm_state=8, ssm_head_dim=8, chunk=8,
                dtype="float32")
    base.update(kw)
    return JConfig(**base), ModelConfig(**base)


_INIT = {"mamba2": (jssm.init_mamba2, ssm.Mamba2),
         "mlstm": (jssm.init_mlstm, ssm.MLSTM),
         "slstm": (jssm.init_slstm, ssm.SLSTM)}


def _block(kind, jcfg, cfg, seed):
    """(reference params, the port's module holding the same values)."""
    init, cls = _INIT[kind]
    p = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for name in ("a_log", "dt_bias", "d_skip", "gate_bias"):
        if name in p:
            p[name] = (p[name] + 0.5 * rng.standard_normal(
                p[name].shape)).astype(np.float32)
    p["norm"]["scale"] = (1 + 0.2 * rng.standard_normal(
        p["norm"]["scale"].shape)).astype(np.float32)
    m = cls(cfg, "cpu", torch.float32)
    with torch.no_grad():
        for name, prm in m.named_parameters():
            leaf = p
            for key in name.split("."):
                leaf = leaf[key]
            assert prm.shape == leaf.shape, name
            prm.copy_(t(leaf))
    return p, m


def _state_np(kind, cfg, b, seed):
    rng = np.random.default_rng(seed)
    if kind == "slstm":
        return tuple(np.abs(rng.standard_normal((b, cfg.d_model))).astype(
            np.float32) for _ in range(3))
    shape = tuple(getattr(ssm, f"init_{kind}_state")(cfg, b, "cpu").shape)
    return rng.standard_normal(shape).astype(np.float32) * 0.3


def _to_port(state):
    return tuple(map(t, state)) if isinstance(state, tuple) else t(state)


def _assert_state(got, want, tol):
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            np.testing.assert_allclose(n(g), np.asarray(w), **tol)
    else:
        np.testing.assert_allclose(n(got), np.asarray(want), **tol)


class TestBlocks:
    @pytest.mark.parametrize("with_state", [False, True])
    @pytest.mark.parametrize("kind", ["mamba2", "mlstm", "slstm"])
    def test_forward_matches_reference(self, kind, with_state):
        jcfg, cfg = _cfg()
        p, m = _block(kind, jcfg, cfg, seed=1)
        x = np.random.default_rng(2).standard_normal(
            (2, 19, cfg.d_model)).astype(np.float32)
        st = _state_np(kind, cfg, 2, 3) if with_state else None
        with torch.no_grad():
            y, state = m(t(x), None if st is None else _to_port(st))
        jy, jstate = getattr(jssm, kind)(p, jcfg, x, st)
        np.testing.assert_allclose(n(y), np.asarray(jy), **BLOCK)
        _assert_state(state, jstate, BLOCK)

    @pytest.mark.parametrize("kind", ["mamba2", "mlstm", "slstm"])
    def test_decode_matches_reference(self, kind):
        """One token from a carried state: the reference's
        ``mamba2_decode`` / ``mlstm_decode``, and ``slstm`` at S = 1 (it
        has no decode function of its own)."""
        jcfg, cfg = _cfg()
        p, m = _block(kind, jcfg, cfg, seed=4)
        x = np.random.default_rng(5).standard_normal(
            (2, 1, cfg.d_model)).astype(np.float32)
        st = _state_np(kind, cfg, 2, 6)
        with torch.no_grad():
            if kind == "slstm":
                y, state = m(t(x), _to_port(st))
            else:
                y, state = m.decode(t(x), _to_port(st))
        fn = jssm.slstm if kind == "slstm" else getattr(
            jssm, f"{kind}_decode")
        jy, jstate = fn(p, jcfg, x, st)
        np.testing.assert_allclose(n(y), np.asarray(jy), **BLOCK)
        _assert_state(state, jstate, BLOCK)

    def test_slstm_long_sequence(self):
        """sLSTM at S 2,048, d 16: |sum log f| reaches the hundreds, where
        a closed-form scan (a cumsum differenced) would cancel."""
        jcfg, cfg = _cfg(d_model=16)
        p, m = _block("slstm", jcfg, cfg, seed=7)
        x = np.random.default_rng(8).standard_normal(
            (2, 2048, 16)).astype(np.float32)
        with torch.no_grad():
            y, state = m(t(x))
        jy, jstate = jax.jit(jssm.slstm, static_argnums=1)(p, jcfg, x)
        np.testing.assert_allclose(n(y), np.asarray(jy), **LONG)
        _assert_state(state, jstate, LONG)
        # the scan itself, on the block's gate pre-activations
        rng = np.random.default_rng(9)
        z, i, f, o = (rng.standard_normal((2, 2048, 16)).astype(np.float32)
                      for _ in range(4))
        c0 = tuple(np.zeros((2, 16), np.float32) for _ in range(3))
        h, (c, nn, mm) = ssm.slstm_scan(t(z), t(i), t(f), t(o),
                                        _to_port(c0))
        jh, (jc, jn, jm) = jax.jit(jssm._slstm_scan)(z, i, f, o, c0)
        log_f = -np.log1p(np.exp(-f.astype(np.float64)))
        assert float(log_f.sum(1).min()) < -600
        np.testing.assert_allclose(n(h), np.asarray(jh), **LONG)
        np.testing.assert_allclose(n(mm), np.asarray(jm), **LONG)
        m64 = np.zeros((2, 16))
        for step in range(2048):
            m64 = np.maximum(log_f[:, step] + m64, i[:, step])
        np.testing.assert_allclose(n(mm), m64, rtol=0, atol=1e-5)

    @pytest.mark.parametrize("s", [1, 5, 16, 33])
    def test_associative_scan_equals_step_loop(self, s):
        rng = np.random.default_rng(s)
        a, b = (t(rng.standard_normal((2, s, 3)).astype(np.float32))
                for _ in range(2))
        got = ssm.associative_scan(ssm.lin_op, (a, b))
        acc = (a[:, 0], b[:, 0])
        want = [acc]
        for i in range(1, s):
            acc = ssm.lin_op(acc, (a[:, i], b[:, i]))
            want.append(acc)
        for g, w in zip(got, zip(*want)):
            torch.testing.assert_close(g, torch.stack(w, dim=1), rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("arch", ["zamba2_1_2b", "xlstm_350m"])
def test_chunked_prefill_then_decode_equals_forward(arch):
    """prefill(prompt of 16 + 1 tokens: a whole chunk and a padded one)
    then two decode steps equal forward over the whole sequence."""
    cfg = configs.get_smoke(arch)
    lm = LM.init(cfg, seed=2, device="cpu")
    b, s = 2, 19
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (b, s)))
    with torch.no_grad():
        full = lm.logits({"tokens": toks})
    cache = lm.init_cache(b, 32)
    lm.prefill({"tokens": toks[:, :s - 2]}, cache)
    for i in (s - 2, s - 1):
        lg, cache = lm.decode_step({"tokens": toks[:, i:i + 1],
                                    "positions": torch.full((b, 1), i)},
                                   cache)
        np.testing.assert_allclose(n(lg[:, 0]), n(full[:, i]), **DECODE)
    kinds = {type(c["state"]).__name__ for c in cache if "state" in c}
    assert kinds == ({"Tensor"} if arch == "zamba2_1_2b"
                     else {"Tensor", "tuple"})
