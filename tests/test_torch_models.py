"""Parity of the port's models with the JAX package's, on the CPU.

The reference's parameters (``init_params``) are carried into the port
with ``repro_torch.convert.lm_params_from_numpy``; inputs are numpy
token ids (or, for musicgen, frame embeddings) from a seed, with image
embeddings of 8 patches for llama-3.2-vision, as tests/test_models.py
makes them.  Tolerances:
  * layers (rms_norm, rope, mlp): rtol = atol = 1e-5, f32 — the same
    arithmetic in another summation order;
  * ``logits`` of the ten SMOKE archs: 2e-4, f32 through two to eight
    layers and a 64- or 128-way head;
  * prefill + teacher-forced decode steps: 2e-3, the reference's own
    decode-vs-forward tolerance (tests/test_models.py);
  * gradients of ``loss`` (autograd against ``jax.grad``): each leaf's
    relative L2 distance at most 1e-4.
The reference's ``"pallas"`` path needs a TPU, so it runs ``"ref"``;
the port runs ``"pallas"`` (the plain version on a CPU tensor), ``"ref"``
and ``"chunked"``.
"""

import contextlib
import dataclasses
import io
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n, t
from repro import configs as jconfigs
from repro.models import decode_step as j_decode_step
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import logits as j_logits
from repro.models import loss as j_loss
from repro.models import prefill as j_prefill
from repro.models.layers import mlp as j_mlp
from repro.models.layers import rms_norm as j_rms_norm
from repro.models.layers import rope as j_rope
from repro_torch import configs, serve
from repro_torch.convert import (
    lm_params_from_numpy, lm_params_to_numpy, lm_tree_to_numpy)
from repro_torch.kernels import launches
from repro_torch.launch import train as launch_train
from repro_torch.models import LM
from repro_torch.models.layers import MLP, rms_norm, rope
from repro_torch.optim import Adam
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train import checkpoint as ckpt

DENSE = ["phi4_mini_3_8b", "granite_3_8b", "starcoder2_15b",
         "nemotron_4_15b"]
# the mixers, MoE, shared attention and the two frontends
OTHER = ["zamba2_1_2b", "xlstm_350m", "musicgen_large",
         "qwen3_moe_235b_a22b", "llama4_maverick_400b_a17b",
         "llama_3_2_vision_90b"]
ARCHS = DENSE + OTHER
LAYER = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=2e-4, atol=2e-4)
DECODE = dict(rtol=2e-3, atol=2e-3)
KEY = jax.random.PRNGKey(0)


def _tokens(seed, vocab, b, s):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def _batch(cfg, seed, b, s):
    """numpy model inputs of ``cfg``: ``tokens``, or ``embeds`` for an
    embed_stub arch; ``image_embeds`` (B, 8, d) for a cross-attention
    arch; ``targets``."""
    rng = np.random.default_rng(seed)
    out = {"targets": rng.integers(0, cfg.vocab, (b, s))}
    if cfg.frontend == "embed_stub":
        out["embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (b, s))
    if "cross_attn" in cfg.block_pattern:
        out["image_embeds"] = rng.standard_normal(
            (b, 8, cfg.d_model)).astype(np.float32)
    return out


def _step(batch, i, extra):
    """Decode input at position i: its token or embedding, and the
    image embeddings; ``extra`` builds positions."""
    out = {k: batch[k][:, i:i + 1] for k in ("tokens", "embeds")
           if k in batch}
    if "image_embeds" in batch:
        out["image_embeds"] = batch["image_embeds"]
    out.update(extra)
    return out


def _inputs(batch):
    """The model inputs of ``_batch`` (targets dropped)."""
    return {k: v for k, v in batch.items() if k != "targets"}


def _torch(batch):
    return {k: t(v) for k, v in batch.items()}


class TestLayers:
    def test_rms_norm(self):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3
        scale = rng.standard_normal(48).astype(np.float32)
        got = rms_norm(t(x), t(scale), 1e-5)
        want = j_rms_norm({"scale": scale}, x, 1e-5)
        np.testing.assert_allclose(n(got), np.asarray(want), **LAYER)

    def test_rms_norm_keeps_bf16(self):
        x = np.random.default_rng(1).standard_normal((3, 64)).astype(
            np.float32)
        got = rms_norm(t(x).to(torch.bfloat16), torch.ones(64), 1e-5)
        assert got.dtype == torch.bfloat16
        want = j_rms_norm({"scale": jnp.ones(64)}, jnp.asarray(
            x, jnp.bfloat16), 1e-5)
        np.testing.assert_allclose(n(got.float()),
                                   np.asarray(want, np.float32), rtol=1e-2,
                                   atol=1e-2)

    @pytest.mark.parametrize("theta", [10000.0, 500000.0])
    def test_rope_to_serve_positions(self, theta):
        """Half-split rotation, f32 angles, positions up to the serve
        cache's 2,560 (an angle of 2,559 rad in the first pair)."""
        rng = np.random.default_rng(2)
        x = rng.standard_normal((2, 40, 3, 16)).astype(np.float32)
        pos = np.stack([np.arange(40), np.arange(2520, 2560)]).astype(
            np.int32)
        got = rope(t(x), t(pos), theta)
        want = j_rope(x, pos, theta)
        np.testing.assert_allclose(n(got), np.asarray(want), **LAYER)
        np.testing.assert_allclose(                     # (S,) positions
            n(rope(t(x), t(pos[1]), theta)),
            np.asarray(j_rope(x, pos[1], theta)), **LAYER)

    @pytest.mark.parametrize("act", ["swiglu", "gelu", "squared_relu"])
    def test_mlp(self, act):
        cfg = configs.get_smoke("phi4_mini_3_8b").with_(act=act)
        rng = np.random.default_rng(3)
        p = {"norm": {"scale": rng.standard_normal(cfg.d_model).astype(
                np.float32)},
             "w_up": rng.standard_normal((cfg.d_model, cfg.d_ff)).astype(
                 np.float32) * 0.1,
             "w_down": rng.standard_normal((cfg.d_ff, cfg.d_model)).astype(
                 np.float32) * 0.1}
        if act == "swiglu":
            p["w_gate"] = rng.standard_normal(
                (cfg.d_model, cfg.d_ff)).astype(np.float32) * 0.1
        x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
        m = MLP(cfg, "cpu", torch.float32)
        with torch.no_grad():
            m.norm.scale.copy_(t(p["norm"]["scale"]))
            for name in ("w_up", "w_down", "w_gate"):
                if name in p:
                    getattr(m, name).copy_(t(p[name]))
            got = m(t(x))
        want = j_mlp(p, jconfigs.get_smoke("phi4_mini_3_8b").with_(act=act),
                     x)
        np.testing.assert_allclose(n(got), np.asarray(want), **LAYER)


@pytest.fixture(scope="module")
def reference():
    """arch -> (reference config with attn_impl="ref", its params)."""
    out = {}
    for arch in ARCHS:
        jcfg = jconfigs.get_smoke(arch).with_(attn_impl="ref")
        out[arch] = (jcfg, j_init_params(KEY, jcfg))
    return out


def _port(reference, arch, impl):
    jcfg, params = reference[arch]
    cfg = configs.get_smoke(arch).with_(attn_impl=impl, attn_block_q=8)
    return lm_params_from_numpy(params, cfg, "cpu")


class TestLM:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_configs_carry_across(self, arch):
        for get in ("get", "get_smoke"):
            assert (dataclasses.asdict(getattr(configs, get)(arch))
                    == dataclasses.asdict(getattr(jconfigs, get)(arch)))

    @pytest.mark.parametrize("arch", ARCHS)
    def test_logits_match_reference(self, reference, arch):
        jcfg, params = reference[arch]
        batch = _inputs(_batch(jcfg, 1, 2, 17))
        want = np.asarray(j_logits(params, jcfg, batch))
        before = dict(launches)
        for impl in ("pallas", "ref", "chunked"):
            lm = _port(reference, arch, impl)
            with torch.no_grad():
                got = lm.logits(_torch(batch))
            assert got.shape == (2, 17, jcfg.vocab)
            np.testing.assert_allclose(n(got), want, err_msg=impl, **LOGITS)
        assert launches == before

    @pytest.mark.parametrize("arch", ARCHS)
    def test_prefill_decode_match_reference(self, reference, arch):
        """prefill(12 positions) + 4 teacher-forced decode steps, in both."""
        jcfg, params = reference[arch]
        b, s0, steps = 2, 12, 4
        batch = _inputs(_batch(jcfg, 2, b, s0 + steps))
        prompt = {k: (v if k == "image_embeds" else v[:, :s0])
                  for k, v in batch.items()}
        jcache = j_init_cache(jcfg, b, 32)
        _, jcache = j_prefill(params, jcfg, prompt, jcache)
        want = []
        for i in range(steps):
            step = _step(batch, s0 + i,
                         {"positions": jnp.full((b, 1), s0 + i, jnp.int32)})
            lg, jcache = j_decode_step(params, jcfg, step, jcache)
            want.append(np.asarray(lg[:, 0]))
        for impl in ("pallas", "ref", "chunked"):
            lm = _port(reference, arch, impl)
            cache = lm.init_cache(b, 32)
            _, cache = lm.prefill(_torch(prompt), cache)
            attn = [c for c in cache if "len" in c]
            assert all(c["len"].tolist() == [s0] * b for c in attn)
            for i in range(steps):
                step = _step(_torch(batch), s0 + i, {
                    "positions": torch.full((b, 1), s0 + i,
                                            dtype=torch.int32)})
                lg, cache = lm.decode_step(step, cache)
                np.testing.assert_allclose(n(lg[:, 0]), want[i],
                                           err_msg=f"{impl} step {i}",
                                           **DECODE)
            assert all(c["len"].tolist() == [s0 + steps] * b for c in attn)
            assert len(attn) == sum(k in ("attn", "cross_attn",
                                          "shared_attn")
                                    for k in lm.kinds)

    def test_cross_attn_without_image_embeds(self, reference):
        """The reference's quirk: with no ``image_embeds`` a cross_attn
        block attends over its own input, with RoPE, non-causally, on
        ``cfg.attn_impl``; prefill and one decode step too."""
        jcfg, params = reference["llama_3_2_vision_90b"]
        toks = _tokens(6, jcfg.vocab, 2, 13)
        want = np.asarray(j_logits(params, jcfg, {"tokens": toks}))
        jcache = j_init_cache(jcfg, 2, 16)
        _, jcache = j_prefill(params, jcfg, {"tokens": toks[:, :12]}, jcache)
        want_step, _ = j_decode_step(params, jcfg, {
            "tokens": toks[:, 12:], "positions": jnp.full((2, 1), 12,
                                                          jnp.int32)}, jcache)
        for impl in ("pallas", "chunked"):
            lm = _port(reference, "llama_3_2_vision_90b", impl)
            with torch.no_grad():
                got = lm.logits({"tokens": t(toks)})
            np.testing.assert_allclose(n(got), want, err_msg=impl, **LOGITS)
            cache = lm.init_cache(2, 16)
            lm.prefill({"tokens": t(toks[:, :12])}, cache)
            lg, _ = lm.decode_step({"tokens": t(toks[:, 12:]),
                                    "positions": torch.full((2, 1), 12)},
                                   cache)
            np.testing.assert_allclose(n(lg), np.asarray(want_step),
                                       err_msg=impl, **DECODE)

    @pytest.mark.parametrize("arch", OTHER)
    def test_loss_gradients_match_reference(self, reference, arch):
        """``LM.loss`` through autograd (remat on) against
        ``jax.grad(repro.models.loss)``: the loss within 1e-5, each
        parameter leaf's gradient within 1e-4 relative L2."""
        jcfg, params = reference[arch]
        batch = _batch(jcfg, 5, 2, 16)
        want_loss, want = jax.jit(jax.value_and_grad(
            lambda p, bt: j_loss(p, jcfg, bt)))(params, batch)
        lm = _port(reference, arch, "chunked")
        loss = lm.loss(_torch(batch))
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
        # musicgen's embedding table feeds nothing (embed_stub): no grad
        got = lm_tree_to_numpy(
            {k: torch.zeros_like(p) if p.grad is None else p.grad
             for k, p in lm.named_parameters()}, lm.cfg)
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        flat_g = jax.tree_util.tree_leaves_with_path(got)
        assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
        for (path, w), (_, g) in zip(flat_w, flat_g):
            w = np.asarray(w, np.float64)
            dist = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
            assert dist <= 1e-4, (jax.tree_util.keystr(path), dist)

    @pytest.mark.parametrize("impl", ["pallas", "chunked"])
    def test_decode_matches_forward(self, impl):
        """Inside the port: prefill(prompt) then one decode step equals
        forward(prompt + next) at the last position."""
        cfg = configs.get_smoke("phi4_mini_3_8b").with_(attn_impl=impl,
                                                        attn_block_q=8)
        lm = LM.init(cfg, seed=3, device="cpu")
        b, s = 2, 17
        toks = t(_tokens(4, cfg.vocab, b, s))
        with torch.no_grad():
            full = lm.logits({"tokens": toks})
        cache = lm.init_cache(b, 32)
        lm.prefill({"tokens": toks[:, :s - 1]}, cache)
        lg, _ = lm.decode_step({"tokens": toks[:, s - 1:],
                                "positions": torch.full((b, 1), s - 1)},
                               cache)
        np.testing.assert_allclose(n(lg[:, 0]), n(full[:, -1]), **DECODE)

    def test_params_round_trip(self, reference):
        _, params = reference["granite_3_8b"]
        back = lm_params_to_numpy(_port(reference, "granite_3_8b", "ref"))
        flat_ref = jax.tree_util.tree_leaves_with_path(params)
        flat_back = jax.tree_util.tree_leaves_with_path(back)
        assert [p for p, _ in flat_ref] == [p for p, _ in flat_back]
        for (path, a), (_, b) in zip(flat_ref, flat_back):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))

    def test_bf16_params_cross_bit_for_bit(self):
        jcfg = jconfigs.get_smoke("nemotron_4_15b").with_(dtype="bfloat16")
        params = j_init_params(KEY, jcfg)
        lm = lm_params_from_numpy(params, configs.get_smoke(
            "nemotron_4_15b").with_(dtype="bfloat16"), "cpu")
        assert lm.blocks[1].attn.wq.dtype == torch.bfloat16
        assert lm.blocks[1].attn.norm.scale.dtype == torch.float32
        np.testing.assert_array_equal(
            n(lm.blocks[1].attn.wq.float()),
            np.asarray(params["blocks"][0]["attn"]["wq"][1], np.float32))

    def test_init_is_seeded(self):
        cfg = configs.get_smoke("starcoder2_15b")
        a = LM.init(cfg, seed=5, device="cpu")
        b = LM.init(cfg, seed=5, device="cpu")
        c = LM.init(cfg, seed=6, device="cpu")
        assert a.blocks[0].ffn.w_gate is None     # gelu: no gate
        for pa, pb, pc in zip(a.parameters(), b.parameters(),
                              c.parameters()):
            assert torch.equal(pa, pb)
        assert not torch.equal(a.embed_group.embed, c.embed_group.embed)

    def test_unknown_block_kind_raises(self):
        """A block kind neither package knows raises ValueError in both."""
        cfg = configs.get_smoke("phi4_mini_3_8b").with_(
            block_pattern=("attn", "conv"))
        with pytest.raises(ValueError, match="conv"):
            LM(cfg, device="cpu")
        with pytest.raises(ValueError):
            j_init_params(KEY, jconfigs.get_smoke("phi4_mini_3_8b").with_(
                block_pattern=("attn", "conv")))

    def test_shared_block_round_trip(self, reference):
        """zamba2 SMOKE: the shared block is one module, once in
        ``named_parameters()``, and ``convert`` gives the reference's tree
        back leaf for leaf, ``shared`` and the None slot included."""
        _, params = reference["zamba2_1_2b"]
        lm = _port(reference, "zamba2_1_2b", "ref")
        names = [k for k, _ in lm.named_parameters()]
        assert sum(k.startswith("shared.") for k in names) == len(
            list(lm.shared.parameters()))
        assert not any(".attn." in k for k in names
                       if k.startswith("blocks."))
        back = lm_params_to_numpy(lm)
        assert back["blocks"][3] is None and params["blocks"][3] is None
        assert (jax.tree_util.tree_structure(back)
                == jax.tree_util.tree_structure(params))
        for (path, a), (_, b) in zip(
                jax.tree_util.tree_leaves_with_path(params),
                jax.tree_util.tree_leaves_with_path(back)):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))

    def test_shared_block_checkpoint_written_once(self, tmp_path):
        """A zamba2 SMOKE trainer's checkpoint holds the shared block's
        leaves once (under ``shared.``), and a resumed trainer restores
        every parameter bitwise and trains on."""
        cfg = configs.get_smoke("zamba2_1_2b")

        def trainer(resume):
            lm = LM.init(cfg, seed=1, device="cpu")
            _, batches = launch_train.make_batches(
                cfg, lm, lgd=False, batch=2, seq=16, corpus=32,
                device="cpu")
            return Trainer(cfg, lm, Adam(lr=1e-3), batches,
                           TrainerConfig(ckpt_dir=str(tmp_path),
                                         ckpt_every=100, log_every=100),
                           resume=resume)

        a = trainer(False)
        a.run(2)
        a.save()
        a.finalize()
        manifest = json.load(open(os.path.join(
            tmp_path, "step_00000002", "manifest.json")))
        paths = [leaf["path"] for leaf in manifest["leaves"]]
        wq = [p for p in paths if p.endswith("attn.wq")]
        assert wq == ["params/shared.attn.wq",
                      "opt_state/m/shared.attn.wq",
                      "opt_state/v/shared.attn.wq"], wq
        assert ckpt.verify(str(tmp_path), 2)[0]
        b = trainer(True)
        assert b.step == 2
        for (k, pa), (_, pb) in zip(a.params.named_parameters(),
                                    b.params.named_parameters()):
            assert torch.equal(pa, pb), k
        out = b.run(1)
        assert np.isfinite(out["losses"]).all()


class TestServe:
    def test_smoke_on_cpu(self, capsys):
        out = serve.main(["--device", "cpu", "--batch", "2",
                          "--prompt-len", "16", "--new-tokens", "4"])
        text = capsys.readouterr().out
        assert re.search(r"prefill 2x16: [\d.]+s", text), text
        m = re.search(r"decode head=full: p10 ([\d.]+) ms/token +p50 "
                      r"([\d.]+) ms/token", text)
        assert m and float(m.group(1)) <= float(m.group(2)), text
        assert "decoded 4 tokens/seq" in text
        assert out["tokens"].shape == (2, 5) and out["finite"]

    def test_greedy_tokens_follow_the_logits(self):
        """The generated tokens are the argmax of a teacher-forced
        forward over the whole generated sequence."""
        cfg, lm = serve.load_model("granite_3_8b", device="cpu", seed=1)
        prompts = serve.make_prompts(cfg, 2, 9, "cpu", seed=2)
        out = serve.generate(lm, prompts, 3)
        seq = torch.cat([prompts, out["tokens"]], dim=1)
        with torch.no_grad():
            full = lm.logits({"tokens": seq[:, :-1]})
        np.testing.assert_array_equal(n(full[:, 8:].argmax(-1)),
                                      n(out["tokens"]))

    def test_needs_a_card_unless_cpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(["--new-tokens", "1"])

    def test_lsh_head_on_cpu(self, capsys):
        """``--head lsh`` at SMOKE: the head line (rows, tables, the
        shortlist a token, the build time) and in-vocabulary tokens, the
        first one from the prompt's last position included."""
        out = serve.main(["--device", "cpu", "--head", "lsh", "--batch",
                          "2", "--prompt-len", "16", "--new-tokens", "4"])
        text = capsys.readouterr().out
        cfg = configs.get_smoke("phi4_mini_3_8b")
        assert re.search(
            rf"head=lsh: {cfg.vocab} rows x 8 tables, shortlist 1536/"
            rf"{cfg.vocab} candidates/token, index build [\d.]+s", text), text
        assert "decode head=lsh" in text
        toks = out["tokens"]
        assert toks.shape == (2, 5) and out["finite"] is None
        assert bool(((toks >= 0) & (toks < cfg.vocab)).all())

    @pytest.mark.parametrize("arch", ["zamba2_1_2b", "musicgen_large",
                                      "llama_3_2_vision_90b"])
    def test_other_archs_on_cpu(self, capsys, arch):
        """``serve --device cpu`` at SMOKE for the Mamba-2 / shared
        attention hybrid, the embed_stub frontend (prompt embeddings,
        then zeros and fresh normals as decode inputs) and the
        cross-attention arch (image embeddings at prefill and at every
        step)."""
        out = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                          "--prompt-len", "16", "--new-tokens", "4"])
        text = capsys.readouterr().out
        name = configs.get_smoke(arch).name
        assert re.search(rf"\[{name}\] prefill 2x16: [\d.]+s", text), text
        assert "decoded 4 tokens/seq" in text
        assert out["tokens"].shape == (2, 5) and out["finite"]

    def test_lsh_head_on_cpu_zamba2(self, capsys):
        out = serve.main(["--arch", "zamba2_1_2b", "--device", "cpu",
                          "--head", "lsh", "--batch", "2", "--prompt-len",
                          "16", "--new-tokens", "4"])
        text = capsys.readouterr().out
        assert "decode head=lsh" in text and "head=lsh: 128 rows" in text
        toks = out["tokens"]
        assert toks.shape == (2, 5) and bool(((toks >= 0)
                                              & (toks < 128)).all())

    @pytest.mark.parametrize("arch", ["zamba2_1_2b", "xlstm_350m"])
    def test_greedy_tokens_follow_the_logits_of_the_mixers(self, arch):
        """Through carried mixer states: the generated tokens are the
        argmax of a teacher-forced forward over the generated sequence."""
        cfg, lm = serve.load_model(arch, device="cpu", seed=1)
        prompts = serve.make_prompts(cfg, 2, 9, "cpu", seed=2)
        out = serve.generate(lm, prompts, 3)
        seq = torch.cat([prompts, out["tokens"]], dim=1)
        with torch.no_grad():
            full = lm.logits({"tokens": seq[:, :-1]})
        np.testing.assert_array_equal(n(full[:, 8:].argmax(-1)),
                                      n(out["tokens"]))

    def test_embed_stub_decode_inputs(self):
        """musicgen's decode inputs: zeros at the first step, then a
        normal from the seeded generator each step; the cache positions
        advance as with tokens."""
        cfg, lm = serve.load_model("musicgen_large", device="cpu", seed=1)
        batch = serve.make_inputs(cfg, 2, 6, "cpu", seed=3)
        assert set(batch) == {"embeds"} and batch["embeds"].shape == (
            2, 6, cfg.d_model)
        a = serve.generate(lm, batch, 3)
        b = serve.generate(lm, batch, 3)
        assert torch.equal(a["tokens"], b["tokens"])
        gen = torch.Generator().manual_seed(serve.DECODE_EMBED_SEED)
        embeds = [batch["embeds"], torch.zeros(2, 1, cfg.d_model)] + [
            torch.randn((2, 1, cfg.d_model), generator=gen)
            for _ in range(2)]
        with torch.no_grad():
            full = lm.logits({"embeds": torch.cat(embeds, dim=1)})
        np.testing.assert_array_equal(n(full[:, 5:].argmax(-1)),
                                      n(a["tokens"]))


class TestLauncher:
    """``python -m repro_torch.launch.train`` on the new archs at SMOKE."""

    def _run(self, *args):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            res = launch_train.main([*args, "--device", "cpu"])
        return res, out.getvalue()

    def test_zamba2_lgd(self):
        res, text = self._run("--arch", "zamba2_1_2b", "--lgd", "--steps",
                              "3")
        assert "zamba2-smoke" in text and len(res["losses"]) == 3
        assert np.isfinite(res["losses"]).all()

    def test_qwen3_moe(self):
        res, text = self._run("--arch", "qwen3_moe_235b_a22b", "--steps", "3")
        assert "qwen3-moe-smoke" in text and len(res["losses"]) == 3
        assert np.isfinite(res["losses"]).all()

    @pytest.mark.parametrize("arch", ["qwen3_moe_235b_a22b",
                                      "llama_3_2_vision_90b"])
    def test_giant_arch_lgd_with_adafactor(self, arch):
        """The giant archs' training recipe at SMOKE size (the card's
        full-width run at reduced depth is chip_smoke.py phase 4i): LGD
        batches through the launcher's one-shard ``ShardedLSHPipeline``
        with an async refresh, Adafactor(lr=1e-2) as the reference's
        dryrun picks it, 4 steps with a refresh swapped in at step 2:
        finite losses,
        every batch-mean weight 1 and shard id 0."""
        from repro_torch.data import ShardedLSHPipeline
        from repro_torch.optim import Adafactor
        cfg, lm = launch_train.load_model(arch, False, "cpu")
        sampler, _ = launch_train.make_batches(
            cfg, lm, lgd=True, batch=4, seq=16, corpus=32, device="cpu",
            refresh_every=2)
        assert isinstance(sampler, ShardedLSHPipeline)
        drawn, draw = [], sampler.next_batch

        def kept():
            b = draw()
            drawn.append(b)
            return b

        sampler.next_batch = kept
        tr = launch_train.make_trainer(cfg, lm, steps=4, lr=1e-3,
                                       sampler=sampler,
                                       optimizer=Adafactor(lr=1e-2))
        losses = tr.run(4)["losses"]
        tr.finalize()
        assert len(losses) == 4 and np.isfinite(losses).all()
        for b in drawn:
            assert abs(float(b["loss_weights"].mean()) - 1.0) <= 1e-5
            assert not b["shard_ids"].any()
        # swapped in at step 2; the next, launched at step 3, is joined by
        # the teardown
        assert [r["ok"] for r in sampler.refresh_records()] == [True, None]

    def test_embed_stub_refused(self):
        with pytest.raises(SystemExit, match="takes precomputed embeddings"):
            self._run("--arch", "musicgen_large", "--steps", "1")
