"""The flash-attention and flash-decode CUDA kernels against their plain
versions, and the model on the card against the model on the CPU.

These need a card and skip without one.  The file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_attention.py

Tolerances: f32 rtol = atol = 1e-5 (same arithmetic, another summation
order); bf16 two bf16 ulps, rtol = 2^-6, with atol = 1e-4 near zero
(kernel and plain version each round an f32 result once, so they part
by at most one ulp).  A bf16 prefill must also be as close to the f32
result (the plain version on the upcast inputs) as the plain bf16
version is: its max |err| from it at most BF16_GOLD_FACTOR times that,
as chip_smoke.py phase 2b holds it.  The model: 1e-4 on f32 logits,
card (kernels) against CPU (plain versions) with the same weights.
"""

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import launches
from repro_torch.kernels.flash_attention import (
    attention_ref,
    decode_ref,
    flash_attention_cuda,
    flash_decode_cuda,
    gqa_attention,
    gqa_decode,
)
from repro_torch.kernels.flash_attention.kernel import decode_chunk, sm_count
from repro_torch.models import LM

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=2 ** -6, atol=1e-4)}
BF16_GOLD_FACTOR = 1.5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


@pytest.mark.parametrize("b,hkv,g,s,d", [
    (1, 8, 3, 2048, 128),  # phi4-mini's serve head shape, one batch row
    (2, 2, 3, 256, 128),   # G = 3 (phi4-mini), several q tiles
    (1, 2, 4, 128, 64),
    (1, 2, 3, 1000, 64),   # ragged S, not a multiple of 64 or 16
    (2, 1, 2, 200, 32),    # ragged S: partial q and k tiles
    (1, 3, 1, 17, 16),     # one partial tile
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention(card, b, hkv, g, s, d, dtype, causal):
    gen = torch.Generator(device=card).manual_seed(s + d + g)
    q = _randn(gen, (b, hkv, g, s, d), dtype, card)
    k = _randn(gen, (b, hkv, s, d), dtype, card)
    v = _randn(gen, (b, hkv, s, d), dtype, card)
    before = launches["flash_attention"]
    got = flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert launches["flash_attention"] == before + 1
    want = attention_ref(q, k, v, causal=causal)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    if dtype == torch.bfloat16:
        gold = attention_ref(q.float(), k.float(), v.float(), causal=causal)
        err = float((got.float() - gold).abs().max())
        plain_err = float((want.float() - gold).abs().max())
        assert err <= BF16_GOLD_FACTOR * plain_err, (err, plain_err)


@pytest.mark.parametrize("b,hkv,g,s,d", [
    (4, 2, 3, 640, 128),   # G = 3, several key tiles
    (3, 1, 8, 256, 64),
    (2, 2, 12, 100, 32),   # G = 12 (starcoder2), ragged S
    (2, 4, 2, 64, 16),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode(card, b, hkv, g, s, d, dtype):
    gen = torch.Generator(device=card).manual_seed(s + d)
    q = _randn(gen, (b, hkv, g, d), dtype, card)
    k = _randn(gen, (b, hkv, s, d), dtype, card)
    v = _randn(gen, (b, hkv, s, d), dtype, card)
    # an empty row (the reference averages v over all S), one past S,
    # and lengths that end inside a tile
    lens = [0, s + 5, 1, s // 2 + 1][:b]
    kv_len = torch.tensor(lens, dtype=torch.int32, device=card)
    before = launches["flash_decode"]
    got = flash_decode_cuda(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert launches["flash_decode"] == before + 1
    torch.testing.assert_close(got.float(),
                               decode_ref(q, k, v, kv_len).float(),
                               **TOL[dtype])


def _hold_decode(got, q, k, v, kv_len, dtype):
    want = decode_ref(q, k, v, kv_len)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    if dtype == torch.bfloat16:
        gold = decode_ref(q.float(), k.float(), v.float(), kv_len)
        err = float((got.float() - gold).abs().max())
        plain_err = float((want.float() - gold).abs().max())
        assert err <= BF16_GOLD_FACTOR * plain_err, (err, plain_err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_serve_cache(card, dtype):
    """phi4-mini's decode shape (B 4, Hkv 8, G 3, D 128) through the
    model's (B, S_max, Hkv, D) cache, rows Hkv * D elements apart, with
    chip_smoke.py's kv_len [1, 777, 2048, 2560]: one launch, split over
    the SMs, merged in the kernel."""
    gen = torch.Generator(device=card).manual_seed(4)
    b, s, hkv, g, d = 4, 2560, 8, 3, 128
    q = _randn(gen, (b, 1, hkv * g, d), dtype, card)
    kc = _randn(gen, (b, s, hkv, d), dtype, card)
    vc = _randn(gen, (b, s, hkv, d), dtype, card)
    kv_len = torch.tensor([1, 777, 2048, 2560], dtype=torch.int32,
                          device=card)
    before = launches["flash_decode"]
    got = gqa_decode(q, kc, vc, kv_len)
    torch.cuda.synchronize()
    assert launches["flash_decode"] == before + 1
    qg = q[:, 0].reshape(b, hkv, g, d)
    _hold_decode(got.reshape(b, hkv, g, d), qg, kc.permute(0, 2, 1, 3),
                 vc.permute(0, 2, 1, 3), kv_len, dtype)
    # the arrival counts are back at 0: a second call agrees bitwise
    again = gqa_decode(q, kc, vc, kv_len)
    torch.cuda.synchronize()
    assert torch.equal(again, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_more_splits_than_keys(card, dtype):
    """A long cache with short rows: 64 splits of 64 keys, of which the
    rows hold 1, 16 and all 64 (kv_len 0: v averaged over all 4,096
    positions)."""
    gen = torch.Generator(device=card).manual_seed(6)
    b, hkv, g, s, d = 3, 1, 2, 4096, 64
    assert decode_chunk(s, b * hkv, sm_count(card.index or 0)) == 64
    q = _randn(gen, (b, hkv, g, d), dtype, card)
    k = _randn(gen, (b, hkv, s, d), dtype, card)
    v = _randn(gen, (b, hkv, s, d), dtype, card)
    kv_len = torch.tensor([40, 1000, 0], dtype=torch.int32, device=card)
    before = launches["flash_decode"]
    got = flash_decode_cuda(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert launches["flash_decode"] == before + 1
    _hold_decode(got, q, k, v, kv_len, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_model_layout_views(card, dtype):
    """The ops read the (B, S, H, D) activations and the (B, S_max, Hkv,
    D) cache in place, through strided views."""
    gen = torch.Generator(device=card).manual_seed(1)
    b, s, hq, hkv, d = 2, 192, 6, 2, 64
    q = _randn(gen, (b, s, hq, d), dtype, card)
    k = _randn(gen, (b, s, hkv, d), dtype, card)
    v = _randn(gen, (b, s, hkv, d), dtype, card)
    torch.testing.assert_close(
        gqa_attention(q, k, v).float(),
        gqa_attention(q, k, v, use_kernel=False).float(), **TOL[dtype])
    kv_len = torch.tensor([5, 192], dtype=torch.int32, device=card)
    torch.testing.assert_close(
        gqa_decode(q[:, :1], k, v, kv_len).float(),
        gqa_decode(q[:, :1], k, v, kv_len, use_kernel=False).float(),
        **TOL[dtype])


def test_wrappers_raise_on_bad_inputs(card):
    q = torch.zeros((1, 1, 1, 64, 48), device=card)
    kv = torch.zeros((1, 1, 64, 48), device=card)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(q, kv, kv)
    q = torch.zeros((1, 1, 1, 64, 32), device=card, dtype=torch.float16)
    kv = torch.zeros((1, 1, 64, 32), device=card, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention_cuda(q, kv, kv)
    q = torch.zeros((1, 1, 1, 64, 32), device=card)
    with pytest.raises(TypeError):
        flash_attention_cuda(q, kv, kv)
    kv = torch.zeros((1, 1, 64, 64), device=card)[..., ::2]
    with pytest.raises(ValueError, match="contiguous last dimension"):
        flash_attention_cuda(q, kv, kv)
    # bf16 rows 36 elements apart: not 16 bytes, so no cp.async
    qb = torch.zeros((1, 1, 1, 64, 36), device=card,
                     dtype=torch.bfloat16)[..., :32]
    kvb = torch.zeros((1, 1, 64, 32), device=card, dtype=torch.bfloat16)
    before = launches["flash_attention"]
    with pytest.raises(ValueError, match="16-byte row strides"):
        flash_attention_cuda(qb, kvb, kvb)
    with pytest.raises(ValueError, match="16-byte row strides"):
        flash_attention_cuda(kvb[:, :, None], kvb, kvb, out=qb)
    assert launches["flash_attention"] == before
    kv = torch.zeros((1, 1, 64, 32), device=card)
    with pytest.raises(ValueError, match="kv_len"):
        flash_decode_cuda(q[:, :, :, 0], kv, kv,
                          torch.ones(1, dtype=torch.int64, device=card))
    with pytest.raises(RuntimeError, match="no backward"):
        gqa_attention(torch.zeros((1, 64, 2, 32), device=card,
                                  requires_grad=True),
                      torch.zeros((1, 64, 1, 32), device=card),
                      torch.zeros((1, 64, 1, 32), device=card))


def test_smoke_model_card_matches_cpu(card):
    """phi4-mini SMOKE (f32, D = 16, G = 2) with the same weights: prefill
    of 2 x 64 tokens and 3 teacher-forced decode steps, the card through
    the kernels, the CPU through the plain versions."""
    cfg = configs.get_smoke("phi4_mini_3_8b").with_(attn_impl="pallas")
    lm_cpu = LM.init(cfg, seed=0, device="cpu")
    lm_gpu = LM(cfg, device=card)
    lm_gpu.load_state_dict(lm_cpu.state_dict())
    toks = torch.randint(0, cfg.vocab, (2, 67),
                         generator=torch.Generator().manual_seed(2))
    logits = {}
    before = dict(launches)
    for name, lm in (("cpu", lm_cpu), ("cuda", lm_gpu)):
        dev = lm.device
        cache = lm.init_cache(2, 80)
        h, cache = lm.prefill({"tokens": toks[:, :64].to(dev)}, cache)
        out = [lm.embed_group.lm_logits(h[:, -1:])[:, 0]]
        for i in range(3):
            lg, cache = lm.decode_step(
                {"tokens": toks[:, 64 + i:65 + i].to(dev),
                 "positions": torch.full((2, 1), 64 + i, device=dev)}, cache)
            out.append(lg[:, 0])
        logits[name] = torch.stack(out).cpu()
    assert launches["flash_attention"] == before["flash_attention"] + 2
    assert launches["flash_decode"] == before["flash_decode"] + 6
    torch.testing.assert_close(logits["cuda"], logits["cpu"], rtol=1e-4,
                               atol=1e-4)
