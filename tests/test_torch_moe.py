"""Parity of the port's MoE FFN (``repro_torch.models.moe``) with the JAX
package's (``repro.models.moe``), on the CPU.

The reference's parameters are copied into the port's module and both
run on the same numpy inputs, f32.  At capacity factor 0.5 (and, for
the busiest experts, at 1.25) tokens overflow their expert's capacity
and are dropped: the kept slots must then be the reference's BITWISE
(the stable sort ranks tokens within an expert in the same order), and
the outputs within rtol = atol = 1e-5 (the same products in another
summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n, t
from repro.models import moe as jmoe
from repro.models.config import ModelConfig as JConfig
from repro_torch.models import ModelConfig
from repro_torch.models import moe

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfg(**kw):
    base = dict(name="moe", n_layers=1, d_model=32, n_heads=4, n_kv_heads=4,
                d_ff=0, vocab=64, moe_experts=8, moe_top_k=2, moe_d_ff=16,
                dtype="float32")
    base.update(kw)
    return JConfig(**base), ModelConfig(**base)


def _moe(jcfg, cfg, seed=0):
    p = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(seed),
                                               jcfg))
    p["norm"]["scale"] = (1 + 0.2 * np.random.default_rng(seed)
                          .standard_normal(jcfg.d_model)).astype(np.float32)
    m = moe.MoE(cfg, "cpu", torch.float32)
    with torch.no_grad():
        for name, prm in m.named_parameters():
            leaf = p
            for key in name.split("."):
                leaf = leaf[key]
            prm.copy_(t(leaf))
    return p, m


def _x(seed, b=3, s=24, d=32):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


def _reference_slots(p, jcfg, x, cap):
    """The reference's (slot, keep) of every group, from its own
    ``_dispatch_one_group``."""
    from repro.models.layers import rms_norm
    h = rms_norm(p["norm"], x, jcfg.norm_eps)
    logits = jnp.einsum("bsd,de->bse", h.astype(jnp.float32), p["router"])
    _, (slot, keep, _, gate) = jax.vmap(
        lambda hh, ll: jmoe._dispatch_one_group(
            hh, ll, jcfg.moe_experts, jcfg.moe_top_k, cap))(h, logits)
    return np.asarray(slot), np.asarray(keep), np.asarray(gate)


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_moe_matches_reference(factor, top_k):
    jcfg, cfg = _cfg(moe_capacity_factor=factor, moe_top_k=top_k)
    p, m = _moe(jcfg, cfg, seed=top_k)
    x = _x(3)
    cap = moe.capacity(cfg, x.shape[1])
    assert cap == max(int(x.shape[1] * top_k / 8 * factor), 1)

    slot, keep, gate = _reference_slots(p, jcfg, x, cap)
    h = moe.rms_norm(t(x), m.norm.scale, cfg.norm_eps)
    with torch.no_grad():
        got_slot, got_keep, got_gate = moe.dispatch_slots(
            h.float() @ m.router, top_k, cap)
    np.testing.assert_array_equal(n(got_keep), keep)
    np.testing.assert_array_equal(n(got_slot), slot)
    np.testing.assert_allclose(n(got_gate), gate, **TOL)
    if factor == 0.5:
        assert not keep.all()                 # drops happen
    with torch.no_grad():
        got = m(t(x))
    want = jmoe.moe_ffn(p, jcfg, x)
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)


def test_moe_equals_exact_routing_at_high_capacity():
    """Inside the port: with room for every token, the FFN is each
    token's top-k experts mixed by their softmaxed gates."""
    jcfg, cfg = _cfg(moe_capacity_factor=8.0)
    _, m = _moe(jcfg, cfg, seed=5)
    x = t(_x(6, b=2, s=8))
    with torch.no_grad():
        got = m(x)
        h = moe.rms_norm(x, m.norm.scale, cfg.norm_eps).reshape(-1, 32)
        top, ex = torch.topk(h @ m.router, 2, dim=-1)
        g = torch.softmax(top, dim=-1)
        out = torch.zeros_like(h)
        for i in range(h.shape[0]):
            for j in range(2):
                e = int(ex[i, j])
                a = (torch.nn.functional.silu(h[i] @ m.experts_gate[e])
                     * (h[i] @ m.experts_up[e]))
                out[i] += g[i, j] * (a @ m.experts_down[e])
    torch.testing.assert_close(got, x + out.reshape(x.shape), rtol=1e-5,
                               atol=1e-5)


def test_moe_gradients_match_reference():
    """Gradients of sum(moe(x)^2) w.r.t. every parameter and x, with
    drops present (capacity factor 0.5)."""
    jcfg, cfg = _cfg(moe_capacity_factor=0.5)
    p, m = _moe(jcfg, cfg, seed=7)
    x = _x(8)
    xt = t(x).requires_grad_()
    (m(xt) ** 2).sum().backward()
    gp, gx = jax.grad(lambda pp, xx: jnp.sum(jmoe.moe_ffn(pp, jcfg, xx) ** 2),
                      argnums=(0, 1))(p, x)
    np.testing.assert_allclose(n(xt.grad), np.asarray(gx), rtol=1e-4,
                               atol=1e-4)
    for name, prm in m.named_parameters():
        leaf = gp
        for key in name.split("."):
            leaf = leaf[key]
        np.testing.assert_allclose(n(prm.grad), np.asarray(leaf), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_aux_load_balance_loss():
    jcfg, cfg = _cfg()
    p, m = _moe(jcfg, cfg, seed=9)
    x = _x(10)
    with torch.no_grad():
        got = moe.aux_load_balance_loss(m, t(x))
    want = jmoe.aux_load_balance_loss(p, jcfg, x)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
