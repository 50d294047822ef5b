"""Parity of the port's models with the JAX package's, on the CPU.

The reference's parameters (``init_params``) are carried into the port
with ``repro_torch.convert.lm_params_from_numpy``; inputs are numpy
token ids from a seed.  Tolerances:
  * layers (rms_norm, rope, mlp): rtol = atol = 1e-5, f32 — the same
    arithmetic in another summation order;
  * ``logits`` of the four dense SMOKE archs: 2e-4, f32 through two
    layers and a 128-way head;
  * prefill + teacher-forced decode steps: 2e-3, the reference's own
    decode-vs-forward tolerance (tests/test_models.py).
The reference's ``"pallas"`` path needs a TPU, so it runs ``"ref"``;
the port runs ``"pallas"`` (the plain version on a CPU tensor), ``"ref"``
and ``"chunked"``.
"""

import dataclasses
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
from repro.models import prefill as j_prefill
from repro.models.layers import mlp as j_mlp
from repro.models.layers import rms_norm as j_rms_norm
from repro.models.layers import rope as j_rope
from repro_torch import configs, serve
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.kernels import launches
from repro_torch.models import LM
from repro_torch.models.layers import MLP, rms_norm, rope

ARCHS = ["phi4_mini_3_8b", "granite_3_8b", "starcoder2_15b",
         "nemotron_4_15b"]
LAYER = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=2e-4, atol=2e-4)
DECODE = dict(rtol=2e-3, atol=2e-3)
KEY = jax.random.PRNGKey(0)


def _tokens(seed, vocab, b, s):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


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
        toks = _tokens(1, jcfg.vocab, 2, 17)
        want = np.asarray(j_logits(params, jcfg, {"tokens": toks}))
        before = dict(launches)
        for impl in ("pallas", "ref", "chunked"):
            lm = _port(reference, arch, impl)
            with torch.no_grad():
                got = lm.logits({"tokens": t(toks)})
            assert got.shape == (2, 17, jcfg.vocab)
            np.testing.assert_allclose(n(got), want, err_msg=impl, **LOGITS)
        assert launches == before

    @pytest.mark.parametrize("arch", ARCHS)
    def test_prefill_decode_match_reference(self, reference, arch):
        """prefill(12 tokens) + 4 teacher-forced decode steps, in both."""
        jcfg, params = reference[arch]
        b, s0, steps = 2, 12, 4
        toks = _tokens(2, jcfg.vocab, b, s0 + steps)
        jcache = j_init_cache(jcfg, b, 32)
        _, jcache = j_prefill(params, jcfg, {"tokens": toks[:, :s0]}, jcache)
        want = []
        for i in range(steps):
            step = {"tokens": toks[:, s0 + i:s0 + i + 1],
                    "positions": jnp.full((b, 1), s0 + i, jnp.int32)}
            lg, jcache = j_decode_step(params, jcfg, step, jcache)
            want.append(np.asarray(lg[:, 0]))
        for impl in ("pallas", "ref", "chunked"):
            lm = _port(reference, arch, impl)
            cache = lm.init_cache(b, 32)
            _, cache = lm.prefill({"tokens": t(toks[:, :s0])}, cache)
            assert cache[0]["len"].tolist() == [s0] * b
            for i in range(steps):
                step = {"tokens": t(toks[:, s0 + i:s0 + i + 1]),
                        "positions": torch.full((b, 1), s0 + i,
                                                dtype=torch.int32)}
                lg, cache = lm.decode_step(step, cache)
                np.testing.assert_allclose(n(lg[:, 0]), want[i],
                                           err_msg=f"{impl} step {i}",
                                           **DECODE)
            assert cache[-1]["len"].tolist() == [s0 + steps] * b

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

    @pytest.mark.parametrize("arch", ["zamba2_1_2b", "qwen3_moe_235b_a22b",
                                      "llama_3_2_vision_90b",
                                      "musicgen_large"])
    def test_unported_archs_name_the_roadmap(self, arch):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            configs.get_smoke(arch)
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            LM(jconfigs.get_smoke(arch), device="cpu")


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
