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
from repro_torch.kernels.flash_attention.kernel import DECODE_TILE, decode_chunk
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


def _tile_loop_bf16(q, k, v, causal, split, bk=64):
    """The arithmetic of the bf16 tensor-core prefill kernel
    (csrc/flash_attention.cu) in plain PyTorch: 64-key tiles, the online
    softmax in f32, P rounded to bf16 for P.V — as hi = bf16(P) plus
    lo = bf16(P - hi) when ``split`` — V in bf16, products summed in f32.
    Products of two bf16 values are exact in f32, as in the mma."""
    s, d = q.shape[-2:]
    scale = d ** -0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full(q.shape[:-1] + (1,), -1e30)
    l = torch.zeros(q.shape[:-1] + (1,))
    acc = torch.zeros(q.shape)
    qpos = torch.arange(s)[:, None]
    for k0 in range(0, s, bk):
        x = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf[:, :, k0:k0 + bk]) * scale
        if causal:
            kpos = torch.arange(k0, min(k0 + bk, s))[None, :]
            x = x.masked_fill(kpos > qpos, -1e30)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        p = torch.exp(x - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        pv = torch.einsum("bhgqk,bhkd->bhgqd", hi, vf[:, :, k0:k0 + bk])
        if split:
            lo = (p - hi).to(torch.bfloat16).float()
            pv = pv + torch.einsum("bhgqk,bhkd->bhgqd", lo,
                                   vf[:, :, k0:k0 + bk])
        acc = acc * alpha + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def _merge(parts):
    """Online-softmax partials (m, l, acc) -> one, as the decode kernel
    merges its warps and then its splits."""
    m = torch.stack([pm for pm, _, _ in parts]).amax(0)
    l = sum(torch.exp(pm - m) * pl for pm, pl, _ in parts)
    acc = sum(torch.exp(pm - m) * pa for pm, _, pa in parts)
    return m, l, acc


def _decode_batches(c0, c1, g, d, bf16, warps=4, tile=32):
    """The key batches of the CUDA decode's partials over keys [c0, c1),
    each batch one rescale of an online softmax.  bf16 (tensor cores):
    every warp computes the whole 32-key tile's softmax, so the block
    holds one partial, a batch a tile.  f32 (CUDA cores): warp w takes
    keys 8 w .. 8 w + 7 of each tile, the G heads in register slots
    (4-float lanes across D, NS a tier of 1, 2, 4, 8, 16), 8 keys a batch
    while the slots are few, fewer as they take more registers."""
    tiles = range(c0, c1, tile)
    if bf16:
        return [[range(k0, min(k0 + tile, c1)) for k0 in tiles]]
    ns = next(tier for tier in (1, 2, 4, 8, 16) if tier * (128 // d) >= g)
    batch = 8 if ns <= 2 else 16 // ns
    per = tile // warps
    return [[range(f, min(f + batch, c1)) for k0 in tiles
             for f in range(k0 + w * per, k0 + (w + 1) * per, batch)
             if f < c1] for w in range(warps)]


def _split_decode(q, k, v, kv_len, chunk):
    """The arithmetic of the split-KV CUDA decode (csrc/flash_attention.cu)
    in plain PyTorch.  Row b's cache is cut into ``chunk``-key splits up
    to end = min(kv_len, S) (all S when kv_len is 0, every logit then
    -1e30); each partial of a split (``_decode_batches``) runs an online
    softmax from m = -1e30, one rescale a batch and only when the max
    moves, with P.V in f32 -- in bf16 with P split into bf16 hi + lo, as
    the tensor cores take it; the partials merge, then the splits that
    hold keys.  Splits past the end never run."""
    b, hkv, g, d = q.shape
    s = k.shape[2]
    scale = d ** -0.5
    bf16 = q.dtype == torch.bfloat16
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.empty(q.shape)
    for bi in range(b):
        n = int(kv_len[bi])
        end = min(n, s) if n > 0 else s
        splits = []
        for c0 in range(0, end, chunk):
            parts = []
            for batches in _decode_batches(c0, min(c0 + chunk, end), g, d,
                                           bf16):
                m = torch.full((hkv, g, 1), -1e30)
                l = torch.zeros((hkv, g, 1))
                acc = torch.zeros((hkv, g, d))
                for keys in batches:
                    x = torch.einsum("hgd,hkd->hgk", qf[bi],
                                     kf[bi, :, keys]) * scale
                    if n <= 0:
                        x = torch.full_like(x, -1e30)
                    m_new = torch.maximum(m, x.amax(-1, keepdim=True))
                    a = torch.where(m_new > m, torch.exp(m - m_new), 1.0)
                    l, acc, m = l * a, acc * a, m_new
                    p = torch.exp(x - m)
                    l = l + p.sum(-1, keepdim=True)
                    if bf16:
                        hi = p.to(torch.bfloat16).float()
                        p_parts = (hi, (p - hi).to(torch.bfloat16).float())
                    else:
                        p_parts = (p,)
                    for pp in p_parts:
                        acc = acc + torch.einsum("hgk,hkd->hgd", pp,
                                                 vf[bi, :, keys])
                parts.append((m, l, acc))
            splits.append(_merge(parts))
        _, l, acc = _merge(splits)
        out[bi] = acc / l.clamp_min(1e-30)
    return out.to(q.dtype)


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
    def test_bf16_tensor_core_arithmetic(self, causal):
        """The bf16 CUDA prefill's arithmetic, emulated tile by tile, holds
        chip_smoke.py's bf16 limits against the plain version: two bf16
        ulps (rtol 2^-6, atol 1e-4), and at most 1.5x the plain bf16
        version's max |err| from the f32 result.  The kernel rounds P to
        bf16 for the tensor cores, so it splits P into hi + lo bf16 parts;
        with P in one bf16 the causal rows' first positions break the
        two-ulp limit (printed with -s, not asserted)."""
        b, hkv, g, s, d = 1, 2, 3, 80, 64     # short causal rows, 2 tiles
        q, k, v = _qkv(80, b, hkv, g, s, d)
        tq, tk, tv = (t(a).to(torch.bfloat16) for a in (q, k, v))
        want = attention_ref(tq, tk, tv, causal=causal).float()
        gold = attention_ref(tq.float(), tk.float(), tv.float(),
                             causal=causal)
        plain_err = float((want - gold).abs().max())
        for split in (True, False):
            got = _tile_loop_bf16(tq, tk, tv, causal, split).float()
            assert got.shape == want.shape
            err = float((got - want).abs().max())
            gold_err = float((got - gold).abs().max())
            holds = torch.allclose(got, want, rtol=2 ** -6, atol=1e-4)
            print(f"P {'hi + lo' if split else 'single'} bf16, causal "
                  f"{causal}: max |err| {err:.6g}, two-ulp limit "
                  f"{'holds' if holds else 'broken'}, from f32 "
                  f"{gold_err:.6g} = {gold_err / plain_err:.4f} x plain")
            if split:
                assert holds, err
                assert gold_err <= 1.5 * plain_err, (gold_err, plain_err)

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

    @pytest.mark.parametrize("b,hkv,g,s,d,lens,sms,n_split,bk", [
        # 4 splits; row 1 ends inside split 1, so splits 2-3 never run
        (2, 2, 3, 256, 64, [256, 100], 8, 4, 128),
        # kv_len 0 (v averaged over S), kv_len > S, a ragged last chunk
        # (200 = 2 x 96 + 8), G 12 (starcoder2's group)
        (3, 1, 12, 200, 32, [0, 250, 65], 4, 3, 200),
        # one split of four holds the row's only key
        (1, 2, 4, 128, 16, [1], 64, 4, 128),
        # phi4-mini's group and head dim
        (4, 2, 3, 320, 128, [1, 777, 200, 320], 16, 4, 64),
    ])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_split_kv_arithmetic(self, b, hkv, g, s, d, lens, sms, n_split,
                                 bk, dtype):
        """The CUDA decode's split-KV schedule and arithmetic, emulated,
        against the JAX kernel in interpret mode and the plain version:
        f32 at (1e-5, 1e-5), bf16 at the reference's bf16 tolerance."""
        chunk = decode_chunk(s, b * hkv, sms)
        assert chunk % DECODE_TILE == 0 and -(-s // chunk) == n_split
        rng = np.random.default_rng(s + g)
        q = _normal(rng, (b, hkv, g, d))
        k, v = _normal(rng, (b, hkv, s, d)), _normal(rng, (b, hkv, s, d))
        kv_len = np.array(lens, np.int32)
        if dtype == "bfloat16":
            (jq, tq), (jk, tk), (jv, tv) = _bf16(q), _bf16(k), _bf16(v)
            tol = BF16
        else:
            (jq, tq), (jk, tk), (jv, tv) = (q, t(q)), (k, t(k)), (v, t(v))
            tol = F32
        got = _split_decode(tq, tk, tv, t(kv_len), chunk)
        assert got.shape == (b, hkv, g, d) and got.dtype == tq.dtype
        want = flash_decode_pallas(jq, jk, jv, kv_len, block_k=bk,
                                   interpret=True)
        np.testing.assert_allclose(n(got.float()),
                                   np.asarray(want, np.float32), **tol)
        np.testing.assert_allclose(
            n(got.float()), n(decode_ref(tq, tk, tv, t(kv_len)).float()),
            **tol)

    @pytest.mark.parametrize("s,rows,sms,chunk,n_split", [
        (2560, 32, 132, 320, 8),    # the serve cache: 256 blocks
        (64, 32, 132, 32, 2),       # never below one tile
        (4096, 2, 132, 64, 64),     # few rows: at most 64 splits
        (32768, 32, 132, 4000, 9),
    ])
    def test_split_schedule(self, s, rows, sms, chunk, n_split):
        """Splits are whole 32-key tiles, about 2 blocks an SM when every
        row is full and at most 64 a row, chosen from the shapes alone."""
        assert decode_chunk(s, rows, sms) == chunk
        assert -(-s // chunk) == n_split

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

    @pytest.mark.parametrize("s", [64, 57])
    @pytest.mark.parametrize("causal", [True, False])
    def test_grads_match_jax(self, s, causal):
        """The q-blocks rematerialised in the backward: q/k/v gradients
        against ``jax.grad`` of the reference's (its scan body is
        ``jax.checkpoint``'d), with block_q 16 dividing S or not."""
        import jax

        b, hq, hkv, d, bq = 2, 4, 2, 16, 16
        rng = np.random.default_rng(s + causal)
        q = _normal(rng, (b, s, hq, d))
        k, v = _normal(rng, (b, s, hkv, d)), _normal(rng, (b, s, hkv, d))
        w = _normal(rng, (b, s, hq, d))
        tq, tk, tv = (t(a).requires_grad_() for a in (q, k, v))
        (chunked_gqa_attention(tq, tk, tv, causal=causal, block_q=bq)
         * t(w)).sum().backward()
        want = jax.grad(
            lambda *a: (j_chunked_gqa_attention(*a, causal=causal,
                                                block_q=bq) * w).sum(),
            argnums=(0, 1, 2))(q, k, v)
        for got, ref in zip((tq, tk, tv), want):
            np.testing.assert_allclose(n(got.grad), np.asarray(ref),
                                       rtol=1e-5, atol=1e-5)

    def test_backward_saves_one_block_of_scores(self):
        """At S 256, block_q 32 the bytes saved for the backward are at
        most the inputs plus one q-block's f32 scores; storing every
        block's scores saves ~29 blocks' worth (7.56 MB)."""
        b, s, hq, hkv, d, bq = 2, 256, 4, 2, 16, 32
        g = torch.Generator().manual_seed(0)
        q = torch.randn(b, s, hq, d, generator=g, requires_grad=True)
        k = torch.randn(b, s, hkv, d, generator=g, requires_grad=True)
        v = torch.randn(b, s, hkv, d, generator=g, requires_grad=True)
        saved = {}

        def pack(x):
            st = x.untyped_storage()
            saved[st.data_ptr()] = st.nbytes()
            return x

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
            out = chunked_gqa_attention(q, k, v, causal=True, block_q=bq)
        inputs = sum(x.numel() * x.element_size() for x in (q, k, v))
        scores = b * hq * bq * s * 4
        assert sum(saved.values()) <= inputs + scores, saved
        out.sum().backward()
        assert all(torch.isfinite(x.grad).all() for x in (q, k, v))

    @pytest.mark.parametrize("s,grad,n_ckpt", [
        (64, True, 4), (16, True, 0), (64, False, 0)])
    def test_checkpoint_only_with_grad_and_several_blocks(
            self, monkeypatch, s, grad, n_ckpt):
        from repro_torch.models import attention_xla

        calls = []

        def counted(*a, **kw):
            calls.append(1)
            return torch.utils.checkpoint.checkpoint(*a, **kw)

        monkeypatch.setattr(attention_xla, "checkpoint", counted)
        q = torch.randn(1, s, 4, 8, requires_grad=True)
        kv = torch.randn(1, s, 2, 8, requires_grad=True)
        with torch.set_grad_enabled(grad):
            out = chunked_gqa_attention(q, kv, kv, block_q=16)
        assert len(calls) == n_ckpt and out.requires_grad == grad


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
