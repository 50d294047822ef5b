"""The port's gather+weight kernel (plain version) and ``sample_gather*``
against the JAX package, on the CPU.

* ``gather_weight``: the port's plain version against the reference's
  XLA version and its Pallas kernel in interpret mode — rows and weights
  bitwise (the kernel's contract is bit-identity), with duplicate ids,
  probabilities below ``p_floor`` (and 0), and row widths that are not
  multiples of 128;
* ``sample_gather`` / ``sample_gather_batched``: the reference's index
  carried across with ``convert``, its draws rebuilt from the same key
  (``jax_sample_draws``): indices, rows, ids and flags bitwise; probs
  and weights at the golden-pin tolerance (rtol 1e-5, atol 1e-7), since
  the collision probability's dot product and the batch mean sum in
  another order (they part by ~4e-7 relative).  Given the reference's
  probabilities, the port's raw weights are bitwise the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from _torch_parity import ATOL, RTOL, jax_sample_draws, n, t
from repro.kernels.gather_weight import gather_weight as j_gather_weight
from repro_torch import convert
from repro_torch.kernels.gather_weight import gather_weight, gather_weight_ref


def _case(n_rows, width, m, seed):
    rng = np.random.default_rng(seed)
    store = rng.integers(0, 200_064, (n_rows, width)).astype(np.int32)
    idx = rng.integers(0, n_rows, m).astype(np.int32)
    idx[: m // 2] = idx[0]                       # duplicate ids
    probs = rng.uniform(1e-6, 0.2, m).astype(np.float32)
    probs[-1] = 0.0                              # below the floor
    if m > 2:
        probs[-2] = 3e-9
    return store, idx, probs


class TestGatherWeight:
    @pytest.mark.parametrize("n_rows,width,m", [
        (2048, 513, 8),       # the LM slice's shape (S+1 = 513)
        (200, 33, 16),        # ragged width
        (64, 128, 5),         # lane-exact width
        (1000, 17, 64),       # short rows, bigger batch
    ])
    @pytest.mark.parametrize("pallas", [False, True],
                             ids=["xla", "pallas-interpret"])
    def test_bitwise_against_reference(self, n_rows, width, m, pallas):
        store, idx, probs = _case(n_rows, width, m, seed=n_rows + width)
        rows, w = gather_weight(t(store), t(idx, torch.int64), t(probs),
                                p_floor=1e-8)
        rows_j, w_j = j_gather_weight(
            jnp.asarray(store), jnp.asarray(idx), jnp.asarray(probs),
            p_floor=1e-8, use_pallas=pallas, interpret=pallas)
        np.testing.assert_array_equal(n(rows), np.asarray(rows_j))
        assert n(w).dtype == np.float32
        np.testing.assert_array_equal(n(w).view(np.uint32),
                                      np.asarray(w_j).view(np.uint32))
        assert (n(w)[-1] == np.float32(1) / (np.float32(1e-8)
                                             * np.float32(n_rows)))

    def test_plain_version_is_index_select(self):
        store, idx, probs = _case(300, 9, 7, seed=3)
        rows, w = gather_weight_ref(t(store), t(idx, torch.int64), t(probs),
                                    p_floor=1e-4)
        np.testing.assert_array_equal(n(rows), store[idx])
        want = np.float32(1) / (np.maximum(probs, np.float32(1e-4))
                                * np.float32(300))
        np.testing.assert_array_equal(n(w), want)

    def test_shape_validation(self):
        store, idx, probs = _case(32, 8, 4, seed=0)
        with pytest.raises(ValueError):
            gather_weight(t(store), t(idx, torch.int64), t(probs)[:3])


def _index(n_pts=300, d=12, seed=4):
    params = J.LSHParams(k=4, l=8, dim=d, family="dense")
    x = jax.random.normal(jax.random.PRNGKey(seed), (n_pts, d))
    x = x / jnp.linalg.norm(x, axis=-1, keepdims=True)
    index = J.mutate_index(None, J.IndexMutation(
        "build", key=jax.random.PRNGKey(seed + 1), x_aug=x), params)
    store = np.random.default_rng(seed).integers(
        0, 997, (n_pts, 33)).astype(np.int32)
    tp = T.LSHParams(k=4, l=8, dim=d, family="dense")
    return params, x, index, store, tp, convert.index_from_numpy(*index)


def _assert_batch(got, want, int_fields=("tokens", "targets", "example_ids",
                                         "indices", "fallback",
                                         "probe_code")):
    for field in int_fields:
        np.testing.assert_array_equal(
            n(getattr(got, field)).astype(np.int64),
            np.asarray(getattr(want, field)).astype(np.int64),
            err_msg=field)
    for field in ("probs", "loss_weights"):
        np.testing.assert_allclose(n(getattr(got, field)),
                                   np.asarray(getattr(want, field)),
                                   rtol=RTOL, atol=ATOL, err_msg=field)


class TestSampleGather:
    @pytest.mark.parametrize("normalize", [True, False])
    @pytest.mark.parametrize("mp", [0, 2])
    def test_sample_gather(self, normalize, mp):
        params, x, index, store, tp, tindex = _index()
        key = jax.random.PRNGKey(7 + mp)
        m, max_probes = 16, max(2 * params.l, 8)
        want = J.sample_gather(key, index, x, x[0], jnp.asarray(store),
                               params, m=m, example_offset=50,
                               multiprobe=mp, normalize=normalize,
                               use_pallas=False)
        got = T.sample_gather(
            None, tindex, t(x), t(x[0]), t(store), tp, m=m,
            example_offset=50, multiprobe=mp, normalize=normalize,
            draws=jax_sample_draws(key, m, max_probes, params.l, 300))
        _assert_batch(got, want)
        if normalize:
            assert abs(float(got.loss_weights.mean()) - 1.0) < 1e-6
        else:     # the weight step itself is bit-identical
            _, w = gather_weight(t(store), t(want.indices, torch.int64),
                                 t(want.probs))
            np.testing.assert_array_equal(n(w), np.asarray(want.loss_weights))

    def test_sample_gather_pallas_reference(self):
        """The reference's kernel path (Pallas probe + gather in interpret
        mode) draws the same batch."""
        params, x, index, store, tp, tindex = _index(n_pts=200, seed=9)
        key = jax.random.PRNGKey(3)
        want = J.sample_gather(key, index, x, x[5], jnp.asarray(store),
                               params, m=8, use_pallas=True, interpret=True)
        got = T.sample_gather(
            None, tindex, t(x), t(x[5]), t(store), tp, m=8,
            draws=jax_sample_draws(key, 8, max(2 * params.l, 8), params.l,
                                   200))
        _assert_batch(got, want)

    def test_sample_gather_batched(self):
        params, x, index, store, tp, tindex = _index(seed=11)
        key = jax.random.PRNGKey(9)
        c, m = 3, 4
        want = J.sample_gather_batched(key, index, x, x[:c],
                                       jnp.asarray(store), params, m=m,
                                       use_pallas=False)
        got = T.sample_gather_batched(
            None, tindex, t(x), t(x[:c]), t(store), tp, m=m,
            draws=jax_sample_draws(key, m, max(2 * params.l, 8), params.l,
                                   300, batch=c))
        assert got.tokens.shape == (c, m, store.shape[1] - 1)
        _assert_batch(got, want)
        np.testing.assert_allclose(n(got.loss_weights).mean(axis=1), 1.0,
                                   rtol=1e-5)

    def test_row_width_and_streaming_guard(self):
        params, x, index, store, tp, tindex = _index()
        g = torch.Generator().manual_seed(0)
        gb = T.sample_gather(g, tindex, t(x), t(x[1]), t(store), tp, m=4,
                             row_width=10)
        assert gb.tokens.shape == (4, 9) and gb.targets.shape == (4, 9)
        np.testing.assert_array_equal(n(gb.targets),
                                      store[n(gb.indices), 1:10])
        # n_live is the host's live count: a tensor would sync each step
        with pytest.raises(TypeError, match="Python int"):
            T.sample_gather(g, tindex, t(x), t(x[1]), t(store), tp, m=4,
                            n_live=torch.tensor(100))
        # a streaming index (slots 200.. empty): the reference's draws,
        # the live-prefix fallback and the weights 1/(p n_live)
        live = np.arange(300) < 200
        jidx = J.mutate_index(None, J.IndexMutation(
            "build", key=jax.random.PRNGKey(5), x_aug=x,
            live_mask=jnp.asarray(live)), params)
        key = jax.random.PRNGKey(9)
        want = J.sample_gather(key, jidx, x, -x[3], jnp.asarray(store),
                               params, m=16, normalize=False,
                               use_pallas=False, n_live=jnp.int32(200))
        got = T.sample_gather(
            None, convert.index_from_numpy(*jidx), t(x), t(-x[3]), t(store),
            tp, m=16, normalize=False, n_live=200,
            draws=jax_sample_draws(key, 16, 16, 8, 300, n_live=200))
        _assert_batch(got, want)
        assert (n(got.indices) < 200).all()
