"""Batched serving: prefill a batch of prompts, then decode greedily.

The PyTorch twin of ``examples/serve.py`` for the dense attention-only
archs.  The model runs with ``attn_impl="pallas"``: on the card the
prompt goes through the hand-written flash-attention kernel once per
layer, and every decode step through the flash-decode kernel once per
layer; with ``--device cpu`` both are their plain PyTorch versions.
Weights are random from a seeded generator (nothing is downloaded) and
the prompts are random token ids.

The first new token is the argmax of the prompt's last position; each
of the ``--new-tokens`` decode steps then feeds the last token and
takes the argmax of its logits, so the cache ends at prompt-len +
new-tokens positions.  Timing is per phase, as the reference prints
it: prefill seconds (prompt forward + first token), and the decode
p10/p50 ms/token over the per-step latencies, the first step timed
apart.

Run:  PYTHONPATH=src python -m repro_torch.serve [--arch phi4_mini_3_8b]
          [--size smoke|full] [--batch 4] [--prompt-len 32]
          [--new-tokens 32] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.kernels import resolve_device
from repro_torch.models import LM, ModelConfig

ROADMAP_LSH_HEAD = ("ROADMAP.md queue 1, item 2 (mips_banded and "
                    "lsh_decode_step)")


def load_model(arch: str, size: str = "smoke", *, device="cuda",
               seed: int = 0):
    """(config, LM) of ``arch`` at ``size`` with random weights, with
    ``attn_impl="pallas"`` (the kernels on the card)."""
    cfg = configs.get(arch) if size == "full" else configs.get_smoke(arch)
    cfg = cfg.with_(attn_impl="pallas")
    return cfg, LM.init(cfg, seed=seed, device=device)


def make_prompts(cfg: ModelConfig, batch: int, prompt_len: int, device,
                 seed: int = 0) -> torch.Tensor:
    """(batch, prompt_len) random token ids from a seeded generator."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                         device=device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def percentiles(step_ms):
    """(p10, p50) of per-step latencies, the first step excluded."""
    steady = step_ms[1:] if len(step_ms) > 1 else step_ms
    return (float(np.percentile(steady, 10)),
            float(np.percentile(steady, 50)))


@torch.inference_mode()
def generate(lm: LM, prompts: torch.Tensor, new_tokens: int) -> dict:
    """Prefill ``prompts`` (B, S), then ``new_tokens`` greedy decode steps.

    Returns the tokens (B, new_tokens + 1), the prefill seconds, the
    per-step ms, the prompt's last hidden state (B, d), the first decode
    step's logits (B, V), and whether every logit was finite (one flag
    kept on the device, read once at the end)."""
    device = prompts.device
    b, s = prompts.shape
    cache = lm.init_cache(b, s + new_tokens)
    _sync(device)
    t0 = time.perf_counter()
    h, cache = lm.prefill({"tokens": prompts}, cache)
    last_hidden = h[:, -1]
    logits = lm.embed_group.lm_logits(h[:, -1:])
    tok = logits.argmax(dim=-1)                                  # (B, 1)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    finite = torch.isfinite(logits).all()
    tokens, step_ms, first_logits = [tok], [], None
    for t in range(new_tokens):
        step = {"tokens": tok,
                "positions": torch.full((b, 1), s + t, dtype=torch.int32,
                                        device=device)}
        t0 = time.perf_counter()
        logits, cache = lm.decode_step(step, cache)
        tok = logits[:, -1:].argmax(dim=-1)
        _sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        finite &= torch.isfinite(logits).all()
        if t == 0:
            first_logits = logits[:, 0]
        tokens.append(tok)
    return {"tokens": torch.cat(tokens, dim=1), "prefill_s": prefill_s,
            "step_ms": step_ms, "last_hidden": last_hidden,
            "first_logits": first_logits,
            "finite": bool(finite)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi4_mini_3_8b",
                    choices=configs.all_archs())
    ap.add_argument("--size", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--head", default="full", choices=["full", "lsh"],
                    help="full: O(V) logits matmul per token (lsh is not "
                         "ported yet)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (plain PyTorch)")
    args = ap.parse_args(argv)
    if args.head == "lsh":
        raise NotImplementedError(
            f"--head lsh needs the banded MIPS family and the LSH decode "
            f"head, which the port does not have yet.  See "
            f"{ROADMAP_LSH_HEAD}")
    device = resolve_device(args.device)

    t0 = time.perf_counter()
    cfg, lm = load_model(args.arch, args.size, device=device)
    _sync(device)
    init_s = time.perf_counter() - t0
    prompts = make_prompts(cfg, args.batch, args.prompt_len, device)
    out = generate(lm, prompts, args.new_tokens)
    b, s = prompts.shape
    print(f"[{cfg.name}] init {init_s:.2f}s on {device}")
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
    if not out["finite"]:
        raise RuntimeError("non-finite logits")
    return out


if __name__ == "__main__":
    main()
