"""Parity of the port's attention modules with the JAX package's.

On the CPU the port's flash-attention entries run their plain PyTorch
versions; they are held against the JAX kernels in Pallas interpret mode
and against the JAX plain versions, on the same numpy inputs, at the
shapes of tests/test_kernels.py plus G = 3 (the phi4-mini group, not a
power of two).  Tolerances: f32 rtol = atol = 1e-5 (the reference's own
kernel tolerance; the sums run in another order), bf16 3e-2 (its bf16
tolerance: both round the f32 result to bf16 once, and the inputs are
bf16).

The CUDA kernels themselves are tested on a card by
tests/test_torch_cuda_attention.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n, t
from repro.kernels.flash_attention import (
    attention_ref as j_attention_ref,
    decode_ref as j_decode_ref,
    flash_attention_pallas,
    flash_decode_pallas,
    gqa_attention as j_gqa_attention,
    gqa_decode as j_gqa_decode,
)
from repro.models.attention_xla import (
    chunked_gqa_attention as j_chunked_gqa_attention,
)
from repro_torch.kernels import launches
from repro_torch.kernels.flash_attention import (
    attention_ref,
    decode_ref,
    flash_attention_cuda,
    flash_decode_cuda,
    gqa_attention,
    gqa_decode,
)
from repro_torch.models.attention_xla import chunked_gqa_attention

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=3e-2, atol=3e-2)


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _qkv(seed, b, hkv, g, s, d):
    rng = np.random.default_rng(seed)
    return (_normal(rng, (b, hkv, g, s, d)), _normal(rng, (b, hkv, s, d)),
            _normal(rng, (b, hkv, s, d)))


def _bf16(a):
    """numpy f32 -> (the JAX bf16 array, the torch bf16 tensor), same bits."""
    return jnp.asarray(a, jnp.bfloat16), t(a).to(torch.bfloat16)


class TestFlashAttention:
    @pytest.mark.parametrize("b,hkv,g,s,d,bq,bk", [
        (1, 1, 1, 128, 64, 64, 64),
        (2, 2, 4, 128, 64, 64, 64),     # GQA group 4
        (1, 1, 2, 256, 128, 128, 64),   # uneven q/k blocks
        (1, 2, 1, 64, 32, 64, 32),      # single q block
        (2, 2, 3, 128, 16, 64, 64),     # G = 3, the smoke head dim
    ])
    @pytest.mark.parametrize("causal", [True, False])
    def test_matches_jax_kernel_and_ref(self, b, hkv, g, s, d, bq, bk,
                                        causal):
        q, k, v = _qkv(s * d + g, b, hkv, g, s, d)
        got = attention_ref(t(q), t(k), t(v), causal=causal)
        assert got.shape == (b, hkv, g, s, d) and got.dtype == torch.float32
        want = flash_attention_pallas(q, k, v, causal=causal, block_q=bq,
                                      block_k=bk, interpret=True)
        np.testing.assert_allclose(n(got), np.asarray(want), **F32)
        np.testing.assert_allclose(
            n(got), np.asarray(j_attention_ref(q, k, v, causal=causal)),
            **F32)

    @pytest.mark.parametrize("g", [2, 3])
    def test_bf16(self, g):
        q, k, v = _qkv(g, 1, 2, g, 128, 64)
        (jq, tq), (jk, tk), (jv, tv) = _bf16(q), _bf16(k), _bf16(v)
        got = attention_ref(tq, tk, tv, causal=True)
        assert got.dtype == torch.bfloat16
        want = flash_attention_pallas(jq, jk, jv, causal=True, block_q=64,
                                      block_k=64, interpret=True)
        np.testing.assert_allclose(n(got.float()),
                                   np.asarray(want, np.float32), **BF16)

    @pytest.mark.parametrize("causal", [True, False])
    def test_gqa_wrapper_model_layout(self, causal):
        b, s, hq, hkv, d = 2, 128, 6, 2, 32
        rng = np.random.default_rng(7)
        q = _normal(rng, (b, s, hq, d))
        k, v = _normal(rng, (b, s, hkv, d)), _normal(rng, (b, s, hkv, d))
        before = dict(launches)
        got = gqa_attention(t(q), t(k), t(v), causal=causal)
        assert launches == before, "a CPU tensor launched a kernel"
        assert got.shape == (b, s, hq, d)
        np.testing.assert_array_equal(
            n(got), n(gqa_attention(t(q), t(k), t(v), causal=causal,
                                    use_kernel=False)))
        want = j_gqa_attention(q, k, v, causal=causal, use_pallas=True,
                               interpret=True, block_q=64, block_k=64)
        np.testing.assert_allclose(n(got), np.asarray(want), **F32)


class TestFlashDecode:
    @pytest.mark.parametrize("b,hkv,g,s,d,bk", [
        (2, 2, 1, 512, 64, 256),
        (1, 4, 4, 1024, 128, 512),
        (3, 1, 8, 256, 64, 128),
        (4, 2, 3, 256, 16, 128),        # G = 3, the smoke head dim
    ])
    def test_matches_jax_kernel_and_ref(self, b, hkv, g, s, d, bk):
        rng = np.random.default_rng(s + d)
        q = _normal(rng, (b, hkv, g, d))
        k, v = _normal(rng, (b, hkv, s, d)), _normal(rng, (b, hkv, s, d))
        kv_len = rng.integers(1, s + 1, (b,)).astype(np.int32)
        got = decode_ref(t(q), t(k), t(v), t(kv_len))
        assert got.shape == (b, hkv, g, d)
        want = flash_decode_pallas(q, k, v, kv_len, block_k=bk,
                                   interpret=True)
        np.testing.assert_allclose(n(got), np.asarray(want), **F32)
        np.testing.assert_allclose(
            n(got), np.asarray(j_decode_ref(q, k, v, kv_len)), **F32)

    def test_bf16_and_empty_row(self):
        """bf16 at the reference's bf16 tolerance; a row with kv_len 0
        averages v over every position, as the reference's softmax over
        all -1e30 logits does (the CUDA kernel keeps that, too)."""
        rng = np.random.default_rng(11)
        b, hkv, g, s, d = 3, 2, 3, 256, 64
        q = _normal(rng, (b, hkv, g, d))
        k, v = _normal(rng, (b, hkv, s, d)), _normal(rng, (b, hkv, s, d))
        kv_len = np.array([0, 100, 256], np.int32)
        (jq, tq), (jk, tk), (jv, tv) = _bf16(q), _bf16(k), _bf16(v)
        got = decode_ref(tq, tk, tv, t(kv_len))
        want = flash_decode_pallas(jq, jk, jv, kv_len, block_k=128,
                                   interpret=True)
        np.testing.assert_allclose(n(got.float()),
                                   np.asarray(want, np.float32), **BF16)
        f32 = decode_ref(t(q), t(k), t(v), t(kv_len))
        np.testing.assert_allclose(
            n(f32)[0], np.broadcast_to(v[0].mean(1)[:, None], (hkv, g, d)),
            **F32)

    def test_gqa_decode_wrapper(self):
        b, s, hq, hkv, d = 2, 256, 12, 4, 32
        rng = np.random.default_rng(3)
        q = _normal(rng, (b, 1, hq, d))
        kc, vc = _normal(rng, (b, s, hkv, d)), _normal(rng, (b, s, hkv, d))
        kv_len = np.array([17, 256], np.int32)
        got = gqa_decode(t(q), t(kc), t(vc), t(kv_len))
        assert got.shape == (b, 1, hq, d)
        want = j_gqa_decode(q, kc, vc, kv_len, use_pallas=True,
                            interpret=True, block_k=128)
        np.testing.assert_allclose(n(got), np.asarray(want), **F32)


class TestChunkedAttention:
    @pytest.mark.parametrize("s,bq", [(32, 8), (33, 8), (64, 64), (17, 32)])
    @pytest.mark.parametrize("causal", [True, False])
    def test_matches_jax(self, s, bq, causal):
        b, hq, hkv, d = 2, 8, 2, 16
        rng = np.random.default_rng(s)
        q = _normal(rng, (b, s, hq, d))
        k, v = _normal(rng, (b, s, hkv, d)), _normal(rng, (b, s, hkv, d))
        got = chunked_gqa_attention(t(q), t(k), t(v), causal=causal,
                                    block_q=bq)
        want = j_chunked_gqa_attention(q, k, v, causal=causal, block_q=bq)
        np.testing.assert_allclose(n(got), np.asarray(want), **F32)
        np.testing.assert_allclose(
            n(got), n(gqa_attention(t(q), t(k), t(v), causal=causal)), **F32)


class TestDispatch:
    def test_kernel_wrappers_refuse_cpu_tensors(self):
        """A wrapper launches its kernel or raises — never runs on."""
        before = dict(launches)
        q = torch.zeros(1, 1, 1, 64, 16)
        kv = torch.zeros(1, 1, 64, 16)
        with pytest.raises(ValueError, match="CUDA tensor"):
            flash_attention_cuda(q, kv, kv)
        with pytest.raises(ValueError, match="CUDA tensor"):
            flash_decode_cuda(q[:, :, :, 0], kv, kv,
                              torch.ones(1, dtype=torch.int32))
        assert launches == before

    def test_other_devices_raise(self):
        q = torch.empty(1, 8, 2, 16, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            gqa_attention(q, q[:, :, :1], q[:, :, :1])
