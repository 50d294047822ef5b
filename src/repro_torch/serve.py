"""Batched serving: prefill a batch of prompts, then decode greedily.

The PyTorch twin of ``examples/serve.py``, for every arch of
``repro_torch.configs``.  The model runs with ``attn_impl="pallas"``: on
the card each self-attention layer's prompt goes through the
hand-written flash-attention kernel once, and each decode step through
the flash-decode kernel once per self-attention layer; with ``--device
cpu`` both are their plain PyTorch versions.  The mixers (Mamba-2,
mLSTM, sLSTM), the MoE FFN and cross-attention are plain PyTorch, as in
the reference.  Weights are random from a seeded generator (nothing is
downloaded).

Inputs, from seeded generators, as the reference's example makes them:
random token ids; for an ``embed_stub`` arch (musicgen) normal prompt
embeddings (B, S, d), and as decode inputs zeros at the first step and
a fresh normal (B, 1, d) at each later one; for a cross-attention arch
(llama-3.2-vision) normal image embeddings (B, n_patches, d), fed at
prefill and at every decode step.

The first new token is the argmax of the prompt's last position; each
of the ``--new-tokens`` decode steps then feeds the last token (or the
next embedding) and takes the argmax of its logits, so the cache ends at
prompt-len + new-tokens positions.

Head (``--head``): ``full`` is the O(V·d) logits matmul and argmax;
``lsh`` the LSH-shortlisted head (``models.sampled_softmax``): a banded
MIPS index over the lm_head rows (``mips_banded``, K sized so a band's
mean bucket holds about 8 rows, L 8, multiprobe 2, 8 candidates a
probed bucket — the reference's recipe) is probed with the hidden state
of every emitted token, the first one included, and the argmax runs
over that static shortlist.  On the card the index is built by the
``simhash`` kernel and every token's probe is one ``bucket_probe_codes``
launch.  Timing is per phase, as the reference prints
it: prefill seconds (prompt forward + first token), and the decode
p10/p50 ms/token over the per-step latencies, the first step timed
apart.

Run:  PYTHONPATH=src python -m repro_torch.serve [--arch phi4_mini_3_8b]
          [--size smoke|full] [--layers N] [--batch 4] [--prompt-len 32]
          [--new-tokens 32] [--head full|lsh] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.kernels import resolve_device
from repro_torch.core.families import get_family
from repro_torch.models import (
    LM, LMHeadIndex, ModelConfig, SampledSoftmaxConfig, lsh_decode_step)
from repro_torch.models.sampled_softmax import lsh_head_tokens

# Seed of an ``embed_stub`` model's decode-step embeddings: one fixed
# stream, as the reference's example draws them from one fixed key.
DECODE_EMBED_SEED = 0


def load_model(arch: str, size: str = "smoke", *, device="cuda",
               seed: int = 0, layers: int = None):
    """(config, LM) of ``arch`` at ``size`` with random weights, with
    ``attn_impl="pallas"`` (the kernels on the card).  ``layers`` keeps
    the config's first ``layers`` layers (a whole number of its block
    pattern): its full width at a depth that fits one card."""
    cfg = configs.get(arch) if size == "full" else configs.get_smoke(arch)
    cfg = cfg.with_(attn_impl="pallas")
    if layers is not None:
        cfg = cfg.with_(n_layers=layers)
    return cfg, LM.init(cfg, seed=seed, device=device)


def lsh_head_config(cfg: ModelConfig) -> SampledSoftmaxConfig:
    """The reference's serving head (examples/serve.py): the banded MIPS
    family, K sized so each band's mean bucket stays within the 8
    candidates a probed bucket gives, L 8, multiprobe 2."""
    fam = get_family("mips_banded")
    band_rows = max(1, cfg.vocab // fam.num_bands())
    return SampledSoftmaxConfig(
        family="mips_banded", k=max(3, band_rows.bit_length() - 3),
        l=8, multiprobe=2, shortlist_per_table=8)


def shortlist_size(scfg: SampledSoftmaxConfig) -> int:
    """Candidates a token: bands x probe codes x tables x per bucket."""
    return (get_family(scfg.family).num_bands() * (1 + scfg.multiprobe)
            * scfg.l * scfg.shortlist_per_table)


def make_prompts(cfg: ModelConfig, batch: int, prompt_len: int, device,
                 seed: int = 0) -> torch.Tensor:
    """(batch, prompt_len) random token ids from a seeded generator."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                         device=device)


def make_inputs(cfg: ModelConfig, batch: int, prompt_len: int, device,
                seed: int = 0) -> dict:
    """The prompt batch of ``cfg``'s arch: ``tokens`` (``make_prompts``),
    or for an ``embed_stub`` arch ``embeds`` (batch, prompt_len, d)
    normal; plus, for a cross-attention arch, ``image_embeds`` (batch,
    ``cfg.n_patches``, d) normal.  f32, from a generator seeded with
    ``seed``."""
    out = {}
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    if cfg.frontend == "embed_stub":
        out["embeds"] = torch.randn((batch, prompt_len, cfg.d_model),
                                    generator=gen, device=device)
    else:
        out["tokens"] = make_prompts(cfg, batch, prompt_len, device, seed)
    if "cross_attn" in cfg.block_pattern:
        out["image_embeds"] = torch.randn((batch, cfg.n_patches, cfg.d_model),
                                          generator=gen, device=device)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def percentiles(step_ms):
    """(p10, p50) of per-step latencies, the first step excluded."""
    steady = step_ms[1:] if len(step_ms) > 1 else step_ms
    return (float(np.percentile(steady, 10)),
            float(np.percentile(steady, 50)))


@torch.inference_mode()
def generate(lm: LM, prompts, new_tokens: int,
             head: LMHeadIndex = None) -> dict:
    """Prefill ``prompts`` (token ids (B, S), or a ``make_inputs`` batch),
    then ``new_tokens`` greedy decode steps.

    An ``embed_stub`` model's decode steps take embeddings: zeros at the
    first, then a normal (B, 1, d) from a generator seeded with
    ``DECODE_EMBED_SEED``, drawn between steps; ``image_embeds`` go with
    every step.  ``head``: None for the full head, or an ``LMHeadIndex``
    whose shortlist picks every emitted token, the first one (from the
    prompt's last position) included.  Returns the tokens (B, new_tokens + 1), the prefill
    seconds, the per-step ms, the prompt's last hidden state (B, d), and
    with the full head the first decode step's logits (B, V) and whether
    every logit was finite (one flag kept on the device, read once at
    the end; None with ``head``, which makes no logits)."""
    batch = prompts if isinstance(prompts, dict) else {"tokens": prompts}
    x = batch.get("tokens", batch.get("embeds"))
    device = x.device
    b, s = x.shape[:2]
    stub = lm.cfg.frontend == "embed_stub"
    extra = ({"image_embeds": batch["image_embeds"]}
             if "image_embeds" in batch else {})
    gen = (torch.Generator(device=device).manual_seed(DECODE_EMBED_SEED)
           if stub else None)
    emb = (torch.zeros((b, 1, lm.cfg.d_model), device=device) if stub
           else None)
    cache = lm.init_cache(b, s + new_tokens)
    _sync(device)
    t0 = time.perf_counter()
    h, cache = lm.prefill(batch, cache)
    last_hidden = h[:, -1]
    finite = None
    if head is None:
        logits = lm.embed_group.lm_logits(h[:, -1:])
        tok = logits.argmax(dim=-1)                              # (B, 1)
        finite = torch.isfinite(logits).all()
    else:
        tok = lsh_head_tokens(lm, h[:, -1:], head)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    tokens, step_ms, first_logits = [tok], [], None
    for t in range(new_tokens):
        step = {"positions": torch.full((b, 1), s + t, dtype=torch.int32,
                                        device=device), **extra}
        if stub:
            step["embeds"] = emb
        else:
            step["tokens"] = tok
        t0 = time.perf_counter()
        if head is None:
            logits, cache = lm.decode_step(step, cache)
            tok = logits[:, -1:].argmax(dim=-1)
        else:
            tok, cache = lsh_decode_step(lm, step, cache, head)
        _sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if head is None:
            finite &= torch.isfinite(logits).all()
            if t == 0:
                first_logits = logits[:, 0]
        if stub:
            emb = torch.randn((b, 1, lm.cfg.d_model), generator=gen,
                              device=device)
        tokens.append(tok)
    return {"tokens": torch.cat(tokens, dim=1), "prefill_s": prefill_s,
            "step_ms": step_ms, "last_hidden": last_hidden,
            "first_logits": first_logits,
            "finite": None if finite is None else bool(finite)}


def build_head(lm: LM, scfg: SampledSoftmaxConfig = None):
    """(``LMHeadIndex`` over ``lm``'s head with the serving recipe, build
    seconds, synchronised)."""
    scfg = lsh_head_config(lm.cfg) if scfg is None else scfg
    _sync(lm.device)
    t0 = time.perf_counter()
    head = LMHeadIndex(lm, scfg)
    _sync(lm.device)
    return head, time.perf_counter() - t0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi4_mini_3_8b",
                    choices=configs.all_archs())
    ap.add_argument("--size", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--head", default="full", choices=["full", "lsh"],
                    help="full: O(V) logits matmul per token; lsh: "
                         "LSH-shortlisted argmax over probed candidates")
    ap.add_argument("--layers", type=int, default=None,
                    help="run the config's first N layers (a multiple of "
                         "its block pattern), e.g. a large arch at full "
                         "width on one card")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (plain PyTorch)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    t0 = time.perf_counter()
    cfg, lm = load_model(args.arch, args.size, device=device,
                         layers=args.layers)
    _sync(device)
    init_s = time.perf_counter() - t0
    print(f"[{cfg.name}] init {init_s:.2f}s on {device}")
    head = None
    if args.head == "lsh":
        head, build_s = build_head(lm)
        print(f"[{cfg.name}] head=lsh: {head.index.n_points} rows x "
              f"{head.index.n_tables} tables, shortlist "
              f"{shortlist_size(head.scfg)}/{cfg.vocab} candidates/token, "
              f"index build {build_s:.2f}s")
    prompts = make_inputs(cfg, args.batch, args.prompt_len, device)
    out = generate(lm, prompts, args.new_tokens, head)
    b, s = args.batch, args.prompt_len
    print(f"[{cfg.name}] prefill {b}x{s}: {out['prefill_s']:.2f}s")
    if args.new_tokens:
        p10, p50 = percentiles(out["step_ms"])
        dt = sum(out["step_ms"]) / 1e3
        print(f"[{cfg.name}] decode head={args.head}: p10 {p10:.2f} ms/token"
              f"  p50 {p50:.2f} ms/token  (first step "
              f"{out['step_ms'][0]:.1f} ms)")
        print(f"decoded {args.new_tokens} tokens/seq in {dt:.2f}s "
              f"({b * args.new_tokens / dt:.1f} tok/s); sample row: "
              f"{out['tokens'][0][:12].tolist()}")
    if out["finite"] is False:
        raise RuntimeError("non-finite logits")
    return out


if __name__ == "__main__":
    main()
