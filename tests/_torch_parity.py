"""Helpers for the parity tests between the JAX package and the PyTorch port.

Inputs are made with numpy and handed to both packages; outputs come
back as numpy.  JAX's threefry and torch's Philox never give the same
bits, so the port's samplers take the reference's draws, rebuilt here
from the same JAX key exactly as ``repro.core.sampler`` splits it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.sampler import _uniform_below
from repro_torch.core.sampler import SampleDraws

# Golden-pin tolerance of the reference's own float parity tests.
RTOL, ATOL = 1e-5, 1e-7

# A code bit may differ only where its projection is this close to 0:
# the two packages sum the projection in different orders.
NEAR_ZERO = 1e-4


def t(a, dtype=None) -> torch.Tensor:
    """numpy / JAX array -> CPU torch tensor (uint32 -> int64)."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    out = torch.from_numpy(np.array(a, copy=True, order="C"))
    return out if dtype is None else out.to(dtype)


def n(x) -> np.ndarray:
    """torch tensor / JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _one(k, max_probes, n_tables, n_points, n_live):
    k_tables, k_slot, k_fb = jax.random.split(k, 3)
    if n_live is None:
        fb = jax.random.randint(k_fb, (), 0, n_points)
    else:   # the live-prefix slot: ``_uniform_below(k_fb, n_live)``
        fb = _uniform_below(k_fb, jnp.int32(n_live))
    return (jax.random.randint(k_tables, (max_probes,), 0, n_tables),
            jax.random.uniform(k_slot, ()), fb)


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6))
def _sample_draws(key, m, max_probes, n_tables, n_points, batch, n_live):
    # one compiled program per shape instead of one per eager op; the
    # random bits are the same under jit
    keys = jax.random.split(key, m if batch is None else (batch, m))
    fn = jax.vmap(lambda k: _one(k, max_probes, n_tables, n_points, n_live))
    if batch is not None:
        fn = jax.vmap(fn)
    return fn(keys)


def jax_sample_draws(key, m, max_probes, n_tables, n_points, batch=None,
                     n_live=None):
    """The draws ``repro.core.sampler.sample`` (``batch=None``) or
    ``sample_batched`` (``batch=B``) makes from ``key``; with ``n_live``
    the fallback draw is the streaming path's live-prefix slot."""
    ts, us, fbs = _sample_draws(key, m, max_probes, n_tables, n_points, batch,
                                n_live)
    return SampleDraws(t(ts, torch.int64), t(us), t(fbs, torch.int64))


def _one_banded(k, max_probes, n_tables):
    k_band, k_tables, k_slot, k_fb = jax.random.split(k, 4)
    return (jax.random.randint(k_tables, (max_probes,), 0, n_tables),
            jax.random.uniform(k_slot, ()), jax.random.uniform(k_band, ()),
            jax.random.uniform(k_fb, ()))


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _banded_draws(key, m, max_probes, n_tables, batch):
    keys = jax.random.split(key, m if batch is None else (batch, m))
    fn = jax.vmap(lambda k: _one_banded(k, max_probes, n_tables))
    if batch is not None:
        fn = jax.vmap(fn)
    return fn(keys)


def jax_banded_draws(key, m, max_probes, n_tables, batch=None):
    """The draws of a banded family's ``sample`` (``batch=None``) or
    ``sample_batched`` (``batch=B``): the reference's four-way key split
    in ``_sample_one_banded`` (band, tables, slot, fallback), its two
    ``_uniform_below`` uniforms as ``band_u`` and ``fallback_u`` (no
    fallback id)."""
    ts, us, bu, fu = _banded_draws(key, m, max_probes, n_tables, batch)
    return SampleDraws(t(ts, torch.int64), t(us), None,
                       band_u=t(bu), fallback_u=t(fu))


def jax_drain_draws(key, m, max_probes, n_tables, n_points):
    """The draws ``repro.core.sampler.sample_drain`` makes from ``key``."""
    k_tables, k_slot, k_fb = jax.random.split(key, 3)
    return SampleDraws(
        t(jax.random.randint(k_tables, (max_probes,), 0, n_tables),
          torch.int64),
        t(jax.random.uniform(k_slot, (m,))),
        t(jax.random.randint(k_fb, (m,), 0, n_points), torch.int64))


def assert_codes_match(got, want, proj, k):
    """(…, L) codes equal except in tables where some projection of the
    row is near zero.  ``proj`` is the reference's (…, L*K) projection.
    Returns the number of codes that differ."""
    got, want = n(got).astype(np.int64), n(want).astype(np.int64)
    near = (np.abs(n(proj)) < NEAR_ZERO).reshape(got.shape + (k,)).any(-1)
    bad = (got != want) & ~near
    assert not bad.any(), f"{bad.sum()} codes differ away from zero"
    return int((got != want).sum())


def assert_results_match(got, want):
    """SampleResult parity: integer fields bitwise, probs at RTOL."""
    for field in ("indices", "n_probes", "bucket_sizes", "fallback",
                  "probe_code"):
        np.testing.assert_array_equal(
            n(getattr(got, field)).astype(np.int64),
            n(getattr(want, field)).astype(np.int64), err_msg=field)
    np.testing.assert_allclose(n(got.probs), n(want.probs), rtol=RTOL,
                               err_msg="probs")
